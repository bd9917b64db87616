#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero before
the result line is printed:

1. device  — require a CUDA card, print its name and power limit
             (nvidia-smi), set and print both TF32 flags (off).
2. build   — compile the kernel libraries from src/repro_torch/kernels/csrc
             with nvcc, one process per source, all started together.
3. kernels — hold every kernel against its plain PyTorch version on the
             card (rtol = atol = 1e-5: the kernel sums each row's slots in
             another order than the plain version's reduction; each row's
             weights sum to 1, as the served graph's mean normalization
             gives them, so a K = 1024 row's rounding stays below the
             bar), at the
             serving path's widths F in {100, 256, 47}, K in {1, 8, 16, 32,
             64} plus a K = 1024 hub bucket, a padded bucket whose real row
             0 must survive, and an empty bucket; then time the kernel, the
             plain version and one library call (torch.sparse.mm) on a
             served batch and on the full graph, with CUDA events.
4. serve   — the main path: build_server on the card for
             serve_products_paper (3-layer GraphSAGE, hidden 256, 100 in,
             47 classes, 16384-node graph), then a warm-up batch and a closed
             burst of 64 single-node requests in batches of 8. Kernel launch
             counts are reset just before and read just after.
5. parity  — the same model at full fanout serves 4 requests in one batch;
             the logits are compared with the full-batch forward on the card
             (fail above 1e-5 of max |logit|). The small flagship spec is
             served on the card and on the CPU (plain versions) from the same
             parameters and compared at rtol = atol = 1e-5.
6. the kernels line (JSON), the nvidia-smi line, and the result line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TOL = 1e-5
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate (data sheet)
FP32_FLOP_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores (data sheet)
SERVE_REQUESTS = 64
BATCH = 8


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "unavailable"


def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median time of one ``fn`` call as its caller pays it: CUDA events
    around each call, so a call whose host side (Python, launch) is slower
    than its kernels is timed at the host's pace."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def device_ms(fn, calls: int = 20, reps: int = 7) -> float:
    """Median device time of one ``fn`` call with the host's launch cost
    hidden: a GPU sleep holds the stream while the host enqueues ``calls``
    calls, and CUDA events around them time the device alone. If the
    sleep ends before the host has enqueued them all, it is doubled and
    the run repeated."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = 10_000_000          # ~5 ms at the H100's ~2 GHz clock
    per_call = []
    while len(per_call) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        late = start.query()     # the device reached `start` before the host was done
        torch.cuda.synchronize()
        if late:
            cycles *= 2
            if cycles > 2**36:
                fail("device_ms: the host cannot enqueue the calls under any sleep")
            continue
        per_call.append(start.elapsed_time(end) / calls)
    return statistics.median(per_call)


def max_err(got, want) -> float:
    """Max |got - want|; fails unless within rtol = atol = TOL."""
    import torch
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, rtol=TOL, atol=TOL):
        fail(f"kernel disagrees with its plain version: max abs err {err}")
    return err


# -- phase 3 -----------------------------------------------------------------


def check_kernels(dev) -> float:
    """Kernel vs plain version over the path's widths and bucket shapes."""
    import numpy as np
    import torch

    from repro_torch.graph.structure import bucketed_ell_from_csr, coo_to_csr
    from repro_torch.kernels import seg_aggregate as sa
    from repro_torch.kernels.ops import padded_device_bucketed
    from repro_torch.kernels.ref import seg_aggregate_ref

    rng = np.random.default_rng(0)
    worst = 0.0
    n = 6000
    for f in (100, 256, 47):
        x = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(dev)
        for k, r in ((1, 4099), (8, 2051), (16, 1024), (32, 512), (64, 256), (1024, 8)):
            idx = torch.from_numpy(rng.integers(0, n, (r, k)).astype(np.int32)).to(dev)
            w = rng.uniform(size=(r, k))
            w = torch.from_numpy((w / w.sum(1, keepdims=True)).astype(np.float32)).to(dev)
            worst = max(worst, max_err(sa.seg_aggregate(x, idx, w),
                                       seg_aggregate_ref(x, idx, w)))
        # Bucketed forward: a hub row, degree-0 rows, real row 0 in a padded
        # bucket, empty buckets, rectangular output.
        src = rng.integers(0, n, 30000)
        dst = rng.integers(0, 3000, 30000)
        dst[:1100] = 77                      # hub of degree >= 1024
        keep = dst != 5                      # row 5 has degree 0
        src, dst = src[keep], dst[keep]
        wt = (1.0 / np.bincount(dst, minlength=3000)[dst]).astype(np.float32)
        ell = bucketed_ell_from_csr(coo_to_csr(src, dst, wt, 3000, n))
        ks = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096]
        caps = [(kk, 4096) for kk in ks]
        lay = padded_device_bucketed(ell, caps, device=dev)
        if not any(b.n == 0 for b in lay.buckets) or not any(
                b.rows[0] == 0 for b in ell.buckets):
            fail("the bucketed check lacks an empty bucket or a real row 0")
        got = sa.bucketed_aggregate(x, lay, 3000)
        worst = max(worst, max_err(got, sa.bucketed_forward_ref(x, lay, 3000)))
        if float(got[0].abs().sum()) == 0.0 or float(got[5].abs().sum()) != 0.0:
            fail("bucketed kernel: row 0 lost or a degree-0 row written")
    print(f"[kernels] seg_aggregate and bucketed forward agree with the plain "
          f"versions at F in (100, 256, 47), K in (1..64, 1024), padded and "
          f"empty buckets: max abs err {worst:.3e} (rtol=atol={TOL})", flush=True)
    return worst


def operator_numbers(name, x, lay, csr, out_rows, n_real) -> dict:
    """Kernel, plain and library times and the bound for one aggregation."""
    import torch

    from repro_torch.kernels import seg_aggregate as sa

    f = x.shape[1]
    err = max_err(sa.bucketed_aggregate(x, lay, out_rows),
                  sa.bucketed_forward_ref(x, lay, out_rows))
    # torch.sparse.mm on the same operator (CSR x dense): a yardstick only.
    crow = torch.zeros(out_rows + 1, dtype=torch.int64)
    crow[1: csr.num_rows + 1] = torch.from_numpy(csr.indptr[1:].astype("int64"))
    crow[csr.num_rows + 1:] = int(csr.indptr[-1])
    a = torch.sparse_csr_tensor(crow, torch.from_numpy(csr.indices.astype("int64")),
                                torch.from_numpy(csr.weights),
                                size=(out_rows, x.shape[0])).to(x.device)
    lib_err = float((torch.sparse.mm(a, x) - sa.bucketed_aggregate(x, lay, out_rows))
                    .abs().max())
    kernel = lambda: sa.bucketed_aggregate(x, lay, out_rows)
    plain = lambda: sa.bucketed_forward_ref(x, lay, out_rows)
    library = lambda: torch.sparse.mm(a, x)
    ms, plain_ms, library_ms = (device_ms(f) for f in (kernel, plain, library))
    call_ms = [time_ms(f) for f in (kernel, plain, library)]
    slots = sum(b.n * b.idx.shape[1] for b in lay.buckets)
    rows = sum(b.n for b in lay.buckets)
    nbytes = slots * 8 + rows * 4 + n_real * f * 4 + out_rows * f * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * slots * f / FP32_FLOP_PER_S * 1e3
    r = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
         "bound_ms": max(bytes_ms, ops_ms),
         "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
         "max_abs_err": err, "call_ms": call_ms}
    print(f"[kernels] {name}: F={f} out_rows={out_rows} src_rows={n_real} "
          f"real_rows={rows} slots={slots} launches={sum(1 for b in lay.buckets if b.n)} "
          f"| device time per call: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
          f"torch.sparse.mm {library_ms:.5f} ms (max diff {lib_err:.2e}); bound "
          f"{r['bound_ms']:.5f} ms ({r['bound_by']}: {nbytes} B) | per call with host "
          f"launch cost: kernel {call_ms[0]:.5f} ms, plain {call_ms[1]:.5f} ms, "
          f"torch.sparse.mm {call_ms[2]:.5f} ms", flush=True)
    return r


def time_serve_shapes(server, dev) -> dict:
    """Time one layer's aggregation at F=256 (and F=100) on a served batch
    of 8 sampled ego-nets, and on the full graph."""
    import numpy as np
    import torch

    from repro_torch.graph.structure import (block_diag_csrs, bucketed_ell_from_csr,
                                             stack_bucketed_ells)
    from repro_torch.kernels.ops import padded_device_bucketed
    from repro_torch.kernels.seg_aggregate import device_bucketed
    from repro_torch.serve.egonet import extract_ego

    rng = np.random.default_rng(1)
    targets = rng.integers(0, server.graph.num_nodes, BATCH)
    egos = [extract_ego(server.csr, [int(t)], server.cfg.num_layers,
                        fanouts=server.fanouts, rng=rng) for t in targets]
    merged = block_diag_csrs([e.csr for e in egos])
    ell = bucketed_ell_from_csr(merged)
    c, caps = server.ladder.class_for(ell)
    lay = padded_device_bucketed(ell, caps, device=dev)
    n_real = merged.num_rows
    print(f"[kernels] serve batch: {BATCH} ego-nets, {n_real} rows, {merged.nnz} "
          f"edges, buckets K={ell.ks}, shape class {c}", flush=True)
    out = {}
    for f in (256, 100):
        x = torch.zeros((c, f), device=dev)
        x[:n_real] = torch.from_numpy(rng.normal(size=(n_real, f)).astype(np.float32)).to(dev)
        out[f"serve_F{f}"] = operator_numbers(f"serve batch F={f}", x, lay, merged, c, n_real)
    full = server.csr
    lay = device_bucketed(stack_bucketed_ells([bucketed_ell_from_csr(full)]), device=dev)
    x = torch.from_numpy(rng.normal(size=(full.num_rows, 256)).astype(np.float32)).to(dev)
    out["full_F256"] = operator_numbers("full graph F=256", x, lay, full,
                                        full.num_rows, full.num_rows)
    return out


# -- phases 4 and 5 ----------------------------------------------------------


def serve_main_path(server) -> dict:
    import numpy as np

    from repro_torch.kernels import seg_aggregate as sa
    from repro_torch.launch.serve import burst

    rng = np.random.default_rng(0)
    n = server.graph.num_nodes
    warm = [[int(v)] for v in rng.integers(0, n, BATCH)]
    requests = [[int(v)] for v in rng.integers(0, n, SERVE_REQUESTS)]
    sa.launches = 0
    server.serve_batch(warm)
    server.stage_seconds = dict.fromkeys(server.stage_seconds, 0.0)
    logits, lat, wall = burst(server, requests, BATCH)
    launches = sa.launches
    st = server.stats()
    lat_ms = np.asarray(lat) * 1e3
    for out in logits:
        if out.shape != (1, server.cfg.num_classes) or not np.all(np.isfinite(out)):
            fail(f"served logits of shape {out.shape} or not finite")
    c = st["cache"]
    r = {"p50_ms": float(np.percentile(lat_ms, 50)),
         "p99_ms": float(np.percentile(lat_ms, 99)),
         "qps": SERVE_REQUESTS / wall, "launches": launches,
         "dispatches": st["batches_dispatched"]}
    print(f"[serve] {SERVE_REQUESTS} requests in batches of {BATCH} after one warm-up "
          f"batch: {wall:.4f} s, {r['qps']:.2f} qps, p50 {r['p50_ms']:.3f} ms, "
          f"p99 {r['p99_ms']:.3f} ms (closed burst)", flush=True)
    print(f"[serve] dispatches={st['batches_dispatched']} shape_classes="
          f"{st['shape_classes']} cache hits={c['hits']} misses={c['misses']} "
          f"refreshes={c['refreshes']} local={c['local_reads']} "
          f"max_age_served={c['max_age_served']} (max_staleness={c['max_staleness']})",
          flush=True)
    print(f"[serve] seg_aggregate kernel launches on the main path: {launches} "
          f"({launches / st['batches_dispatched']:.2f} per dispatch)", flush=True)
    if launches <= 0:
        fail("the main path launched no seg_aggregate kernel")
    stages = st["stage_seconds"]
    print("[serve] host seconds per stage over the burst: " + ", ".join(
        f"{k} {v:.4f} s ({v / wall:.1%})" for k, v in stages.items())
        + f"; other {wall - sum(stages.values()):.4f} s", flush=True)
    r.update(device_busy(server, rng))
    return r


def device_busy(server, rng) -> dict:
    """Device busy share of a second, profiled burst of 16 requests: the sum
    of the device activities torch.profiler records over the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import burst

    requests = [[int(v)] for v in rng.integers(0, server.graph.num_nodes, 16)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, wall = burst(server, requests, BATCH)
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in dev) * 1e-6
    agg = [e for e in dev if "seg_aggregate" in e.name]
    agg_s = sum(e.time_range.elapsed_us() for e in agg) * 1e-6
    if not dev:
        print(f"[serve] profiled burst of 16 requests: wall {wall:.4f} s, device "
              "busy share not measured (the profiler recorded no device activity)",
              flush=True)
        return {"device_busy_share": None}
    print(f"[serve] profiled burst of 16 requests: wall {wall:.4f} s, device busy "
          f"{busy_s:.6f} s ({busy_s / wall:.2%}; idle {1 - busy_s / wall:.2%}) over "
          f"{len(dev)} device activities; seg_aggregate kernels {len(agg)}, "
          f"{agg_s:.6f} s", flush=True)
    return {"device_busy_share": busy_s / wall,
            "agg_kernel_s": agg_s, "agg_kernels_seen": len(agg)}


def parity(dev) -> None:
    import numpy as np

    from repro_torch.configs.serve_products_paper import FLAGSHIP, serve_products_paper
    from repro_torch.serve import ServeSpec, build_server

    server = build_server(serve_products_paper("serve.fanouts=full"), device=dev)
    probe = [int(v) for v in np.random.default_rng(2).integers(
        0, server.graph.num_nodes, 4)]
    served = np.concatenate(server.serve_batch([[t] for t in probe]))
    full = server.full_batch_logits()[np.asarray(probe)]
    diff = float(np.abs(served - full).max())
    scale = float(np.abs(full).max())
    bitwise = bool(np.array_equal(served, full))
    print(f"[parity] full fanout, 4 requests in one batch (shape classes "
          f"{server.shape_classes()}) vs full-batch forward on the card: max abs "
          f"diff {diff:.3e}, max |logit| {scale:.3e}, bitwise {bitwise}", flush=True)
    if not np.all(np.isfinite(served)) or diff > TOL * scale:
        fail(f"served logits differ from the full-batch forward by {diff}")

    small = ServeSpec.from_dict(FLAGSHIP)
    on_card = build_server(small, device=dev)
    on_cpu = build_server(small, device="cpu")
    reqs = [[1], [50], [200], [7, 8]]
    for a, b in zip(on_card.serve_batch(reqs), on_cpu.serve_batch(reqs)):
        if not np.allclose(a, b, rtol=TOL, atol=TOL):
            fail(f"card and CPU serving differ by {np.abs(a - b).max()}")
    print(f"[parity] small flagship spec served on the card and on the CPU "
          f"(plain versions) agree within rtol=atol={TOL}", flush=True)


def main() -> None:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    dev = torch.device("cuda")
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)} (count "
          f"{torch.cuda.device_count()}); nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    print(f"[device] torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    from repro_torch.configs.serve_products_paper import serve_products_paper
    from repro_torch.kernels import build
    from repro_torch.serve import build_server

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[build] {len(libs)} kernel libraries in {time.perf_counter() - t0:.2f} s: "
          f"{', '.join(p.name for p in libs)}", flush=True)
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    worst = check_kernels(dev)

    t0 = time.perf_counter()
    spec = serve_products_paper()
    server = build_server(spec, device=dev)
    g = server.graph
    print(f"[serve] built {spec.describe()} in {time.perf_counter() - t0:.2f} s: "
          f"{g.num_nodes} nodes, {g.num_edges} edges, {server.cfg.model} "
          f"x{server.cfg.num_layers} dims {server.cfg.dims()}", flush=True)
    timings = time_serve_shapes(server, dev)
    served = serve_main_path(server)
    parity(dev)

    t = timings["serve_F256"]
    kernels = [{
        "name": "seg_aggregate",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/seg_aggregate.cu",
        "replaces": "src/repro/kernels/seg_aggregate.py:91",
        "launches": served["launches"],
        "max_abs_err": max(worst, *(v["max_abs_err"] for v in timings.values())),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
    }]
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
