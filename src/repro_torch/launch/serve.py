"""Online inference launcher on the card: serve per-node requests from a ServeSpec.

The port of ``repro.launch.serve``: a :class:`repro_torch.serve.ServeSpec`
(``--spec file.json`` + ``--set`` overrides) is lowered by
``build_server`` onto a live :class:`~repro_torch.serve.server.GNNServer`
on ``--device`` (the card by default; it raises if there is none), then
``--requests N`` synthetic single-node requests are drawn and answered
through the batched block-diagonal path. It reports p50/p99 latency,
throughput, cache counters, kernel launches and — with full fanout — the
bit-parity check against the full-batch forward.

Examples:
  python -m repro_torch.launch.serve --spec specs/serve_flagship.json --requests 64
  python -m repro_torch.launch.serve --spec specs/serve_flagship.json \
      --set serve.fanouts=10,5 --set serve.batch_size=16 --unbatched
  python -m repro_torch.launch.serve --spec specs/serve_flagship.json --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import List, Sequence, Tuple


def burst(server, requests: Sequence[Sequence[int]], batch_size: int,
          unbatched: bool = False) -> Tuple[List, List[float], float]:
    """Serve a closed burst: all requests present at t=0; a request's
    latency is the time from burst start to its dispatch completing.
    Returns (per-request logits, per-request latencies in seconds, wall
    seconds)."""
    out: List = []
    lat: List[float] = []
    t0 = time.perf_counter()
    if unbatched:
        for r in requests:
            out.append(server.serve(r))
            lat.append(time.perf_counter() - t0)
    else:
        for i in range(0, len(requests), batch_size):
            chunk = requests[i: i + batch_size]
            out.extend(server.serve_batch(chunk))
            done = time.perf_counter() - t0
            lat.extend([done] * len(chunk))
    return out, lat, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Serve per-node GNN inference requests from a ServeSpec")
    ap.add_argument("--spec", required=True,
                    help="ServeSpec JSON ({'run': ..., 'serve': ...})")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="override, e.g. serve.batch_size=16 or "
                         "exec.seed=1 (run-section keys pass through)")
    ap.add_argument("--requests", type=int, default=64,
                    help="synthetic single-node requests to serve")
    ap.add_argument("--unbatched", action="store_true",
                    help="one dispatch per request (baseline mode)")
    ap.add_argument("--no-parity", action="store_true",
                    help="skip the full-batch bit-parity check")
    ap.add_argument("--seed", type=int, default=0,
                    help="request-stream seed")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.kernels import seg_aggregate as sa
    from repro_torch.serve import ServeSpec, build_server

    spec = ServeSpec.load(args.spec).with_overrides(args.set)
    print(f"spec: {spec.describe()}")
    server = build_server(spec, device=args.device)
    g = server.graph
    print(f"graph: {g.num_nodes} nodes, {g.num_edges} edges; "
          f"model {server.cfg.model} x{server.cfg.num_layers} layers on "
          f"{server.device}; params from fresh init")

    rng = np.random.default_rng(args.seed)
    requests = [[int(v)] for v in
                rng.integers(0, g.num_nodes, size=args.requests)]
    sa.launches = 0
    _, lat, wall = burst(server, requests, spec.serve.batch_size, args.unbatched)

    lat_ms = np.asarray(lat) * 1e3
    st = server.stats()
    print(f"served {len(requests)} requests in {wall:.3f}s "
          f"({len(requests) / wall:.1f} qps, "
          f"{'unbatched' if args.unbatched else f'batch={spec.serve.batch_size}'})")
    print(f"latency p50={np.percentile(lat_ms, 50):.2f}ms "
          f"p99={np.percentile(lat_ms, 99):.2f}ms")
    print(f"dispatches={st['batches_dispatched']} "
          f"shape_classes={st['shape_classes']} kernel_launches={sa.launches}")
    c = st["cache"]
    print(f"cache: hits={c['hits']} misses={c['misses']} "
          f"refreshes={c['refreshes']} local={c['local_reads']} "
          f"max_age_served={c['max_age_served']} "
          f"(max_staleness={c['max_staleness']})")

    if not args.no_parity and server.fanouts is None:
        probe = [int(v) for v in rng.integers(0, g.num_nodes, size=4)]
        ok = server.check_parity(probe)
        print(f"parity vs full-batch forward on {probe}: "
              f"{'bit-identical' if ok else 'MISMATCH'}")
        if not ok:
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
