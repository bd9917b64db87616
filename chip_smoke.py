#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --wire [TREE]   # phases 1, 2 and 6 only, on the
                                          # kernels of the checkout at TREE
    python3 chip_smoke.py --experiments   # phase 9's SAGE run, then ROADMAP
                                          # C2's plain-aggregation run and a
                                          # rank's cost of the stacked draws

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
6. wire    — quant_pack and dequant_unpack against their plain versions at
             the Int2 wire's shape (28,032 rows) for bits in {2, 4, 8} and
             F in {100, 256, 47}: packed words, zero, scale and the
             dequantized values must be bitwise equal; then times at the
             Int2 wire's two widths, F = 256 and F = 100, back to back and
             after a 64 MB write that evicts the L2.
7. train   — the training main path: build_session on the card for
             train_products_paper (3-layer GraphSAGE, hidden 256, 16384-node
             graph, 8 workers stacked, hierarchical 2x4, Int2 inter wire,
             inter_cd=2). The stacked seg_aggregate and its backward are held
             to their plain versions on the session's own layouts (rtol =
             atol = 1e-5). On all ten stacked layouts (local graph, intra and
             inter send-side pre-aggregations and receive scatters, and the
             reverse of each), at F in (100,
             256, 47), two launches must give the same bits and agree with
             the plain version; each layout is timed at F = 256 beside the
             plain version, torch.sparse.mm and the bound, with one launch
             per call. The send-side pre-aggregation must repeat bitwise
             forward and backward on the ell and coo backends. Then the
             launch counts are reset, 4 epochs run (refresh and stale epochs
             of the inter cache, twice) and the model is evaluated; every
             kernel must have launched. A fifth, profiled epoch gives the
             device's busy share and top operations. Then
             specs/coo_fallback.json (vmap, agg_backend=coo): two runs of 4
             epochs bitwise equal, and one resumed from epoch 2 bitwise
             equal to them (ROADMAP C1).
8. train parity — the small flagship spec (vmap) for 3 epochs on the card
             and on the CPU, randomness drawn on the CPU and copied to both:
             fp32 inter wire within 1e-5, Int2 inter wire within 1e-3.
9. single  — train_gcn_single on the card: the paper's GraphSAGE (ogbn-
             products preset, 16384-node stand-in), then GAT (ogbn-arxiv
             preset: 128 in, hidden 256, 40 classes, 4 heads, 8192 nodes),
             4 epochs with an eval after each; launch counts reset just
             before and read just after; each epoch's loss on the card and
             on the CPU from the same state and draws within 1e-5 (the
             free-running gap is printed); epoch times of single_train_step
             and one profiled step. The one-graph layout's forward (ell) and
             backward (ell_t) against the plain versions and timed at F=256.
10. gat serve — serve_products_paper as GAT (one head: 47 classes) at full
             fanout: 8 requests in one dispatch, bitwise equal to the
             full-batch forward.
11. ckpt   — train_products_paper for 4 epochs against 2 epochs
             checkpointed and a fresh session resumed to 4: losses and state
             bitwise; then build_server with serve.ckpt: parameters equal to
             the trained ones and served logits equal to the full-batch
             forward, bitwise; checkpoint MB, save and restore seconds.
12. multiproc — train_products_paper as 8 processes sharing the card
             (exec.mode=multiproc: host mailboxes in shared memory), 4 epochs
             and one evaluation, held to phase 7's stacked losses (epoch 0
             within 1e-5, the rest within phase 8's Int2 bar 1e-3); every
             rank must launch seg_aggregate, its backward, quant_pack and
             dequant_unpack (ranks report their launches in their epoch
             stats); epoch ms, mailbox wait_s and wire_bytes of refresh and
             stale epochs, per-rank RSS and device memory; no leaked
             segment. Before the fleet starts, every kernel is held at the
             shapes a rank gives it: seg_aggregate forward and backward on
             each rank's [1, ...] slice of the ten training layouts (two
             launches bitwise, bitwise equal to the rank's row of a stacked
             launch, within 1e-5 of the plain version), and quant_pack and
             dequant_unpack on the rank's psum-scattered [G*s, F] inter
             shard at F = 100 and 256, bitwise equal to the plain versions.
13. recovery — a chaos kill of one rank after epoch 2, with a checkpoint
             every epoch: losses bitwise equal to phase 12's, no leaked
             segment; detection, respawn and restore seconds.
14. the kernels line (JSON, with each kernel's launches on every path), the
             nvidia-smi line, and the result line.
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


def _syncs(fn) -> bool:
    """Whether one ``fn`` call makes the host wait for the device."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        return False
    except RuntimeError:
        return True
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


def device_ms(fn, what: str = "", calls: int = 20, reps: int = 7, between=None) -> float:
    """Median device time of one ``fn`` call with the host's launch cost
    hidden: a GPU sleep holds the stream while the host enqueues ``calls``
    calls, and CUDA events around them time the device alone. If the
    sleep ends before the host has enqueued them all, it is doubled and
    the run repeated. With ``between`` (say, a write that evicts the L2),
    it runs before each call, and events around each call time ``fn``
    alone. A call that waits for the device (so no sleep can hide its host
    side), or one the host cannot enqueue under a 4 s sleep, is timed
    instead as the profiler's sum of its device activities per call, and a
    line says so."""
    import torch
    fn()
    syncs = _syncs(fn)
    cycles = 10_000_000          # ~5 ms at the H100's ~2 GHz clock
    per_call = []
    while not syncs and len(per_call) < reps and cycles <= 2**33:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        pairs = []
        for _ in range(calls):
            if between is None:
                fn()
                continue
            between()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        end.record()
        late = start.query()     # the device reached `start` before the host was done
        torch.cuda.synchronize()
        if late:
            cycles *= 2
            continue
        per_call.append(sum(a.elapsed_time(b) for a, b in pairs) / calls if pairs
                        else start.elapsed_time(end) / calls)
    if len(per_call) == reps:
        return statistics.median(per_call)
    _, busy_s, _ = profile_device(lambda: [fn() for _ in range(calls)])
    print(f"[timing] {what or 'a timed call'} waits for the device, or its host "
          f"side outlasts a 4 s sleep: its device time is the profiler's sum of "
          f"its device activities over {calls} calls", flush=True)
    return busy_s / calls * 1e3


def max_err(got, want) -> float:
    """Max |got - want|; fails unless within rtol = atol = TOL."""
    import torch
    torch.cuda.synchronize()
    err = float((got - want).detach().abs().max()) if got.numel() else 0.0
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


def aggregation_bytes(lay, in_rows: int, out_values: int, f: int):
    """(bytes, edges) one aggregation over ``lay`` must move, counted from
    this run's layout: 8 B (source id and weight) per real edge (a slot of
    nonzero weight in a real row), 4 B per real row's destination id, each
    source row that a real edge names read once, and each of the
    ``out_values`` output values written once. Padding rows, padded slots
    and source rows no edge names (a stack pads every worker to the largest
    worker's rows) are not counted."""
    import torch

    edges = rows = 0
    sources = []
    for b in lay.buckets:
        if not b.n:
            continue
        idx, w, counts = b.idx, b.w, b.counts
        if counts is None:                       # one graph: a stack of one
            idx, w = idx[None], w[None]
            counts = torch.tensor([b.n], device=idx.device)
        real = (torch.arange(idx.shape[1], device=idx.device)[None, :]
                < counts[:, None].long())
        live = (w != 0) & real[..., None]
        edges += int(live.sum())
        rows += int(counts.sum())
        off = torch.arange(idx.shape[0], device=idx.device)[:, None, None] * in_rows
        sources.append((idx.long() + off)[live])
    src_rows = int(torch.unique(torch.cat(sources)).numel()) if sources else 0
    return edges * 8 + rows * 4 + src_rows * f * 4 + out_values * 4, edges


def operator_numbers(name, x, lay, csr, out_rows, n_real) -> dict:
    """Kernel, plain and library times and the bound for one aggregation."""
    import torch

    from repro_torch.kernels import seg_aggregate as sa

    f = x.shape[1]
    before = sa.launches
    err = max_err(sa.bucketed_aggregate(x, lay, out_rows),
                  sa.bucketed_forward_ref(x, lay, out_rows))
    per_call = sa.launches - before
    if per_call != 1:
        fail(f"{name}: {per_call} kernel launches for one aggregation call")
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
    ms, plain_ms, library_ms = (device_ms(fn, f"{name}: {what}") for fn, what in (
        (kernel, "kernel"), (plain, "plain"), (library, "torch.sparse.mm")))
    call_ms = [time_ms(f) for f in (kernel, plain, library)]
    slots = sum(b.n * b.idx.shape[1] for b in lay.buckets)
    rows = sum(b.n for b in lay.buckets)
    nbytes, edges = aggregation_bytes(lay, x.shape[0], out_rows * f, f)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * edges * f / FP32_FLOP_PER_S * 1e3
    r = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
         "bound_ms": max(bytes_ms, ops_ms),
         "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
         "max_abs_err": err, "call_ms": call_ms,
         "launches_per_call": per_call}
    print(f"[kernels] {name}: F={f} out_rows={out_rows} src_rows={n_real} "
          f"real_rows={rows} slots={slots} edges={edges} "
          f"launches per call={per_call} "
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


def profile_device(fn):
    """Run ``fn`` under torch.profiler: (wall s, device busy s, device
    seconds by operation name), busy being the sum of the device activities
    the profiler records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-6
    return wall, sum(by_name.values()), by_name


def device_busy(server, rng) -> dict:
    """Device busy share of a second, profiled burst of 16 requests."""
    from repro_torch.launch.serve import burst

    requests = [[int(v)] for v in rng.integers(0, server.graph.num_nodes, 16)]
    wall, busy_s, by_name = profile_device(lambda: burst(server, requests, BATCH))
    agg_s = sum(v for k, v in by_name.items() if "seg_aggregate" in k)
    if not by_name:
        print(f"[serve] profiled burst of 16 requests: wall {wall:.4f} s, device "
              "busy share not measured (the profiler recorded no device activity)",
              flush=True)
        return {"device_busy_share": None}
    print(f"[serve] profiled burst of 16 requests: wall {wall:.4f} s, device busy "
          f"{busy_s:.6f} s ({busy_s / wall:.2%}; idle {1 - busy_s / wall:.2%}); "
          f"seg_aggregate kernels {agg_s:.6f} s", flush=True)
    return {"device_busy_share": busy_s / wall, "agg_kernel_s": agg_s}


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


# -- phase 6: the quantized wire's kernels ------------------------------------

WIRE_ROWS = 28032   # Int2 inter wire of train_products_paper: 8 workers x 3504 rows


def compare_quant(x, u, bits, f) -> tuple:
    """quant_pack and dequant_unpack vs their plain versions on one input;
    fails unless bitwise equal. Returns max |kernel - plain| over the
    dequantized values of quant_pack's output and of dequant_unpack."""
    import torch

    from repro_torch.kernels import quant_pack as qp
    from repro_torch.kernels.ref import dequant_unpack_ref, quant_pack_ref

    got = qp.quant_pack(x, u, bits)
    want = quant_pack_ref(x, u, bits)
    for name, a, b in zip(("packed", "zero", "scale"), got, want):
        if not torch.equal(a, b):
            fail(f"quant_pack {tuple(x.shape)} bits={bits}: {name} differs from the "
                 f"plain version in {int((a != b).sum())} places")
    plain = dequant_unpack_ref(*want, bits, f)
    deq = qp.dequant_unpack(*want, bits, f)
    if not torch.equal(deq, plain):
        fail(f"dequant_unpack {tuple(x.shape)} bits={bits}: differs from the plain "
             "version")
    return (float((dequant_unpack_ref(*got, bits, f) - plain).abs().max()),
            float((deq - plain).abs().max()))


def check_quant_kernels(dev) -> dict:
    """quant_pack / dequant_unpack vs their plain versions, bitwise, at the
    wire's shape; times at F = 256 and F = 100, bits = 2."""
    import numpy as np
    import torch

    from repro_torch.kernels import quant_pack as qp
    from repro_torch.kernels.ref import dequant_unpack_ref, quant_pack_ref

    rng = np.random.default_rng(3)
    errs = {"quant_pack": 0.0, "dequant_unpack": 0.0}

    def note(e) -> None:
        for name, v in zip(errs, e):
            errs[name] = max(errs[name], v)

    for bits in (2, 4, 8):
        for f in (100, 256, 47):
            x = rng.normal(size=(WIRE_ROWS, f)).astype(np.float32)
            x[8:12] = 0.25                          # a group with an empty range
            u = rng.uniform(size=(WIRE_ROWS, f)).astype(np.float32)
            u[:4] = np.float32(1.0) - np.float32(2.0**-24)  # noise next to 1
            note(compare_quant(torch.from_numpy(x).to(dev),
                               torch.from_numpy(u).to(dev), bits, f))
    print(f"[wire] quant_pack and dequant_unpack equal their plain versions bitwise "
          f"(packed words, zero, scale, dequantized values) at {WIRE_ROWS} rows, "
          f"bits in (2, 4, 8), F in (100, 256, 47)", flush=True)

    # Times on the Int2 wire at both widths it carries (layer 0: F = 100).
    # dequant_unpack's output (28.7 MB at F = 256) fits in the 50 MB L2, so
    # back-to-back calls can beat the HBM bound; the second timing writes a
    # 64 MB scratch buffer before each call, which evicts the L2.
    bits = 2
    flush_buf = torch.empty(16 * 2**20, dtype=torch.float32, device=dev)
    flush = lambda: flush_buf.fill_(1.0)
    groups = WIRE_ROWS // 4
    out = {}
    for f in (256, 100):
        x = torch.from_numpy(rng.normal(size=(WIRE_ROWS, f)).astype(np.float32)).to(dev)
        u = torch.rand((WIRE_ROWS, f), device=dev)
        note(compare_quant(x, u, bits, f))
        packed, zero, scale = qp.quant_pack(x, u, bits)
        words = packed.shape[1]
        for name, kernel, plain, nbytes in (
                ("quant_pack", lambda: qp.quant_pack(x, u, bits),
                 lambda: quant_pack_ref(x, u, bits),
                 WIRE_ROWS * f * 8 + WIRE_ROWS * words * 4 + groups * 8),
                ("dequant_unpack", lambda: qp.dequant_unpack(packed, zero, scale, bits, f),
                 lambda: dequant_unpack_ref(packed, zero, scale, bits, f),
                 WIRE_ROWS * words * 4 + groups * 8 + WIRE_ROWS * f * 4)):
            ms = device_ms(kernel, name)
            flushed_ms = device_ms(kernel, f"{name} after a 64 MB write", between=flush)
            plain_ms = device_ms(plain, f"{name} plain")
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            r = {"ms": ms, "ms_after_flush": flushed_ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}
            if f == 256:
                out[name] = r
            else:
                out[name][f"F{f}"] = r
            print(f"[wire] {name} at {WIRE_ROWS} rows, F={f}, bits={bits}: device time "
                  f"per call kernel {ms:.5f} ms ({ms / bound_ms:.2f}x bound), "
                  f"{flushed_ms:.5f} ms after a 64 MB write, plain {plain_ms:.5f} ms; "
                  f"bound {bound_ms:.5f} ms (bytes: {nbytes} B)", flush=True)
    for name, e in errs.items():
        out[name]["max_abs_err"] = e
        print(f"[wire] {name}: max abs err {e:.3e} over every compared shape", flush=True)
    return out


# -- phase 7: training ---------------------------------------------------------


def _block_diag_csr(lay, out_rows, in_rows, dev):
    """The stacked layout as one block-diagonal sparse matrix [P*out_rows,
    P*in_rows], for the torch.sparse.mm yardstick."""
    import torch

    rows, cols, vals = [], [], []
    for b in lay.buckets:
        p = b.idx.shape[0]
        real = torch.arange(b.idx.shape[1], device=dev)[None, :] < b.counts[:, None].long()
        off = torch.arange(p, device=dev)[:, None]
        r = (b.rows.long() + off * out_rows)[real]
        c = (b.idx.long() + (off * in_rows)[..., None])[real]
        w = b.w[real]
        rows.append(r[:, None].expand_as(c).reshape(-1))
        cols.append(c.reshape(-1))
        vals.append(w.reshape(-1))
    p = lay.buckets[0].idx.shape[0]
    a = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]),
                                torch.cat(vals), (p * out_rows, p * in_rows))
    return a.coalesce().to_sparse_csr()


def train_layouts(session) -> list:
    """The ten stacked layouts of the training path: (name, layout, source
    rows, output rows, whether it is a backward layout)."""
    wd = session.wd
    m = wd.x.shape[1]
    out = [("local", wd.ell, m, m, False), ("local_t", wd.ell_t, m, m, True)]
    for name, plan in (("intra", wd.hier_plan.intra), ("inter", wd.hier_plan.inter)):
        wire = plan.send_gather_idx.shape[1]
        out += [(f"{name} pre", plan.pre_ell, m, wire, False),
                (f"{name} pre_t", plan.pre_ell_t, wire, m, True),
                (f"{name} receive", plan.recv_ell, wire, m, False),
                (f"{name} receive_t", plan.recv_ell_t, m, wire, True)]
    return out


def check_repeats(layouts, dev) -> float:
    """On every layout at F in (100, 256, 47): two launches bit for bit, and
    the kernel against the plain version."""
    import torch

    from repro_torch.kernels import seg_aggregate as sa

    worst = 0.0
    for name, lay, n_in, n_out, _ in layouts:
        p = lay.buckets[0].idx.shape[0]
        for f in (100, 256, 47):
            x = torch.randn((p, n_in, f), device=dev)
            a = sa._bucketed_forward(x, lay, n_out)
            if not torch.equal(a, sa._bucketed_forward(x, lay, n_out)):
                fail(f"{name} F={f}: two launches differ")
            worst = max(worst, max_err(a, sa.bucketed_forward_ref(x, lay, n_out)))
        print(f"[train] {name}: two launches agree bit for bit at F in (100, 256, 47)",
              flush=True)
    return worst


def stacked_numbers(name, lay, in_rows, out_rows, f, dev, backward) -> dict:
    """Kernel vs plain on one stacked layout; the kernel's, the plain
    version's and a library call's (torch.sparse.mm over the block-diagonal
    matrix) times, and the bound."""
    import torch

    from repro_torch.kernels import seg_aggregate as sa

    p = lay.buckets[0].idx.shape[0]
    x = torch.randn((p, in_rows, f), device=dev)
    kernel = lambda: sa._bucketed_forward(x, lay, out_rows, backward=backward)
    before = sa.launches + sa.backward_launches
    y = kernel()
    per_call = sa.launches + sa.backward_launches - before
    if per_call != 1:
        fail(f"{name}: {per_call} kernel launches for one aggregation call")
    plain = lambda: sa.bucketed_forward_ref(x, lay, out_rows)
    err = max_err(y, plain())
    a = _block_diag_csr(lay, out_rows, in_rows, dev)
    xf = x.reshape(p * in_rows, f)
    library = lambda: torch.sparse.mm(a, xf)
    lib_err = float((library().reshape(p, out_rows, f) - y).abs().max())
    ms = device_ms(kernel, f"{name}: kernel")
    plain_ms = device_ms(plain, f"{name}: plain")
    library_ms = device_ms(library, f"{name}: torch.sparse.mm")
    slots = sum(int(b.counts.sum()) * b.idx.shape[-1] for b in lay.buckets)
    real_rows = sum(int(b.counts.sum()) for b in lay.buckets)
    nbytes, edges = aggregation_bytes(lay, in_rows, p * out_rows * f, f)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * edges * f / FP32_FLOP_PER_S * 1e3
    r = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
         "bound_ms": max(bytes_ms, ops_ms),
         "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
         "launches_per_call": per_call, "max_abs_err": err}
    print(f"[train] {name}: {p} workers, F={f}, {in_rows}->{out_rows} rows, real rows "
          f"{real_rows}, slots {slots}, edges {edges}, {per_call} launch per call | "
          f"max abs err {err:.3e} | device time per call: kernel {ms:.5f} ms, plain "
          f"{plain_ms:.5f} ms, torch.sparse.mm {library_ms:.5f} ms (max diff "
          f"{lib_err:.2e}); bound {r['bound_ms']:.5f} ms ({r['bound_by']}: {nbytes} B)",
          flush=True)
    return r


def check_train_kernels(session, dev) -> dict:
    """The stacked aggregation and its backward on the session's own
    layouts, and the autograd path through them, against the plain
    versions; two launches against each other; times of every layout."""
    import torch

    from repro_torch.kernels import seg_aggregate as sa

    wd = session.wd
    m = wd.x.shape[1]
    inter = wd.hier_plan.inter
    wire = inter.send_gather_idx.shape[1]
    worst = 0.0
    for f in (100, 256, 47):
        for lay, lay_t, n_in, n_out in ((wd.ell, wd.ell_t, m, m),
                                        (inter.recv_ell, inter.recv_ell_t, wire, m)):
            x = torch.randn((wd.x.shape[0], n_in, f), device=dev, requires_grad=True)
            y = sa.bucketed_aggregate(x, lay, n_out, ell_t=lay_t)
            worst = max(worst, max_err(y, sa.bucketed_forward_ref(x.detach(), lay, n_out)))
            g = torch.randn_like(y)
            (dx,) = torch.autograd.grad(y, x, g)
            worst = max(worst, max_err(dx, sa.bucketed_forward_ref(g, lay_t, n_in)))
    print(f"[train] stacked seg_aggregate forward and backward (autograd over the "
          f"reverse layout) agree with the plain versions on the local and the "
          f"inter receive layouts at F in (100, 256, 47): max abs err {worst:.3e} "
          f"(rtol=atol={TOL})", flush=True)
    layouts = train_layouts(session)
    worst = max(worst, check_repeats(layouts, dev))
    numbers = {name: stacked_numbers(name, lay, n_in, n_out, 256, dev, bwd)
               for name, lay, n_in, n_out, bwd in layouts}
    for r in (numbers["local"], numbers["local_t"]):
        r["max_abs_err"] = max(r["max_abs_err"], worst)
    return {"forward": numbers["local"], "backward": numbers["local_t"]}


def pre_aggregation_repeats(session, dev) -> dict:
    """The send-side pre-aggregation of each stage (``assemble_send``)
    repeated three times on the same input at F=256, forward and backward,
    on the ``ell`` backend (the kernel) and on the ``coo`` backend (the
    sorted scatter-add): each must repeat bitwise, or a resumed run could
    not equal an uninterrupted one."""
    import torch

    from repro_torch.core.exchange import assemble_send

    wd, out = session.wd, {}
    for name, plan in (("intra", wd.hier_plan.intra), ("inter", wd.hier_plan.inter)):
        h = torch.randn((wd.x.shape[0], wd.x.shape[1], 256), device=dev)
        for backend in ("ell", "coo"):
            fwd, bwd = [], []
            for _ in range(3):
                x = h.clone().requires_grad_(True)
                y = assemble_send(x, plan, backend)
                g = torch.ones_like(y) if not bwd else g
                fwd.append(y.detach())
                bwd.append(torch.autograd.grad(y, x, g)[0])
            out[f"{name} {backend}"] = (all(torch.equal(fwd[0], v) for v in fwd),
                                        all(torch.equal(bwd[0], v) for v in bwd))
    print("[train] send-side pre-aggregation repeated 3 times at F=256, (forward, "
          "backward) bitwise: " + ", ".join(f"{k} {v}" for k, v in out.items()),
          flush=True)
    bad = [k for k, v in out.items() if not all(v)]
    if bad:
        fail(f"the send-side pre-aggregation does not repeat bit for bit: {bad}")
    return out


def coo_phase(dev) -> dict:
    """specs/coo_fallback.json (vmap, ``agg_backend="coo"``) on the card:
    two runs of 4 epochs with an eval after each must be bitwise equal, and
    2 epochs checkpointed then resumed to 4 must equal the uninterrupted
    run, losses and state (ROADMAP C1)."""
    import tempfile

    import numpy as np

    from repro_torch.checkpoint.ckpt import _flatten
    from repro_torch.run import RunSpec, build_session

    spec = lambda n: RunSpec.load(ROOT / "specs" / "coo_fallback.json").with_overrides(
        [f"exec.epochs={n}"])

    def same(a, b) -> bool:
        fa, fb = _flatten(a.trainer.train_state()), _flatten(b.trainer.train_state())
        return sorted(fa) == sorted(fb) and all(np.array_equal(fa[k], fb[k]) for k in fa)

    runs = [build_session(spec(4), device=dev) for _ in range(2)]
    hists = [r.fit(log_every=1) for r in runs]
    with tempfile.TemporaryDirectory() as d:
        build_session(spec(2), device=dev).fit(log_every=1, ckpt_dir=d)
        resumed = build_session(spec(4), device=dev)
        tail = resumed.fit(log_every=1, ckpt_dir=d, resume=True)
    r = {"repeat": hists[0] == hists[1] and same(*runs),
         "resume": tail == hists[0][2:] and same(resumed, runs[0]),
         "losses": [h["loss"] for h in hists[0]]}
    print(f"[coo] specs/coo_fallback.json (vmap, agg_backend=coo) on the card, 4 epochs: "
          f"losses {r['losses']}; two runs bitwise (losses, eval, state) {r['repeat']}; "
          f"resumed from epoch 2 bitwise {r['resume']}", flush=True)
    if not (r["repeat"] and r["resume"]):
        fail("the coo backend does not repeat or resume bit for bit on the card")
    return r


def counts() -> dict:
    """Every kernel's launch count so far."""
    from repro_torch.kernels import launch_counts

    return launch_counts()


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    from repro_torch.kernels import quant_pack as qp
    from repro_torch.kernels import seg_aggregate as sa

    sa.launches = sa.backward_launches = qp.pack_launches = qp.unpack_launches = 0


TRAIN_EPOCHS = 4


def train_main_path(session) -> dict:
    """4 epochs of train_products_paper on the card, then evaluate; the
    kernel launch counts are reset just before and read just after."""
    import math

    import torch

    reset_counts()
    epochs = []
    for _ in range(TRAIN_EPOCHS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = session.train_epoch()
        torch.cuda.synchronize()
        m["ms"] = (time.perf_counter() - t0) * 1e3
        epochs.append(m)
    acc = session.evaluate()
    launched = counts()
    for i, m in enumerate(epochs):
        print(f"[train] epoch {i}: loss {m['loss']:.6f} train_acc {m['train_acc']:.4f} "
              f"{m['ms']:.3f} ms (CUDA-synchronized host clock)", flush=True)
        if not math.isfinite(m["loss"]):
            fail(f"non-finite training loss at epoch {i}: {m['loss']}")
    print(f"[train] eval accuracy after {TRAIN_EPOCHS} epochs: {acc:.4f}", flush=True)
    print(f"[train] kernel launches on the main path ({TRAIN_EPOCHS} epochs + eval): "
          + ", ".join(f"{k} {v}" for k, v in launched.items()), flush=True)
    for k, v in launched.items():
        if v <= 0:
            fail(f"the training main path launched no {k} kernel")
    if launched["quant_pack"] != launched["dequant_unpack"]:
        fail("quant_pack and dequant_unpack launched unequal times: each wire "
             "call launches each once")
    wall, busy_s, by_name = profile_device(session.train_epoch)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    if by_name:
        print(f"[train] profiled epoch: wall {wall:.4f} s, device busy {busy_s:.6f} s "
              f"({busy_s / wall:.2%}; idle {1 - busy_s / wall:.2%})", flush=True)
        for name, sec in top:
            print(f"[train]   {sec * 1e3:9.3f} ms {sec / busy_s:6.1%}  {name[:90]}",
                  flush=True)
    else:
        print(f"[train] profiled epoch: wall {wall:.4f} s, device busy share not "
              "measured (the profiler recorded no device activity)", flush=True)
    return {"epochs": epochs, "eval_acc": acc, "launches": launched,
            "device_busy_share": busy_s / wall if by_name else None}


# -- phase 8: training on the card vs the CPU ----------------------------------


def train_parity(dev) -> None:
    import numpy as np

    from repro_torch.configs.train_products_paper import FLAGSHIP
    from repro_torch.core import GeneratorRandomness
    from repro_torch.run import RunSpec, build_session

    base = RunSpec.from_dict(FLAGSHIP)

    def losses(spec, device):
        s = build_session(spec, device=device,
                          randomness=GeneratorRandomness(spec.exec.seed, draw_device="cpu"))
        return np.array([s.train_epoch()["loss"] for _ in range(3)])

    for label, extra, tol, why in (
            ("fp32 inter wire", ["schedule.inter_bits=0"], 1e-5,
             "cuBLAS and the CPU's BLAS sum in other orders (last-bit differences)"),
            ("Int2 inter wire", [], 1e-3,
             "a last-bit difference before the stochastic rounding can move one "
             "element across a floor(), which changes it by a whole quantization "
             "level")):
        spec = base.with_overrides(extra)
        card, card2, cpu = losses(spec, dev), losses(spec, dev), losses(spec, "cpu")
        diff = float(np.abs(card - cpu).max())
        print(f"[parity] small flagship spec, {label}, 3 epochs: card losses "
              f"{card.tolist()}, CPU losses {cpu.tolist()}; max diff {diff:.3e} "
              f"(bar {tol}: {why}); two card runs identical: "
              f"{bool(np.array_equal(card, card2))}", flush=True)
        if not np.all(np.isfinite(card)) or diff > tol:
            fail(f"training on the card and on the CPU differ by {diff} ({label})")


# -- phases 9 to 11: single-device training, GAT, checkpoints -------------------

SINGLE_EPOCHS = 4


def raw_graph(spec):
    """(graph, features) of a RunSpec's graph section before normalization,
    which is what train_gcn_single takes (it normalizes itself)."""
    import repro_torch.run.sources as sources
    from repro_torch.run.spec import FEATURE_SOURCES, GRAPH_SOURCES

    gs = spec.graph
    g = GRAPH_SOURCES.get(gs.source)(gs)
    return g, FEATURE_SOURCES.get(sources.resolve_features(gs))(g, gs)


def preset_graph(name: str):
    """The raw SBM stand-in of a paper preset, as train_products_paper
    builds its graph section (for ogbn-products, that very graph)."""
    from repro_torch.configs.graphsage_paper import PAPER_PRESETS
    from repro_torch.configs.train_products_paper import FLAGSHIP
    from repro_torch.run import RunSpec

    p = PAPER_PRESETS[name]
    return raw_graph(RunSpec.from_dict(FLAGSHIP).with_overrides([
        f"graph.nodes={p.sbm_nodes}", f"graph.avg_degree={p.sbm_degree}",
        f"graph.feat_dim={p.feat_dim}", f"graph.classes={p.num_classes}"]))


def single_phase(label: str, g, x, cfg, dev) -> dict:
    """train_gcn_single on the card for SINGLE_EPOCHS epochs with an eval
    after each (the main path: counts reset just before, read just after),
    held to the CPU with the same draws (made on the CPU): each epoch's
    step from the card's own state, run once on the card and once on the
    CPU, losses within TOL. The free-running gap (the whole run repeated on
    the CPU from the same initial parameters) is printed, not held to a
    bar: AdamW's first steps move each weight by about lr * sign(gradient),
    so a weight whose gradient is near zero, with another sign under the
    other device's summation order, moves by up to 2 lr, and the two runs
    drift apart from there. Then epoch times of single_train_step alone,
    with draws made on the card, and one profiled step."""
    import math

    import numpy as np
    import torch

    from repro_torch.core import GeneratorRandomness, train_gcn_single
    from repro_torch.core import model as M
    from repro_torch.core.trainer import prepare_single, single_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import AdamWState, tree_map

    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    draws = lambda: GeneratorRandomness(0, draw_device="cpu")
    runs = []
    for where in (dev, "cpu"):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, hist = train_gcn_single(g, x, cfg, SINGLE_EPOCHS, log_every=1, device=where,
                                   params=params, randomness=draws())
        torch.cuda.synchronize()
        runs.append((hist, time.perf_counter() - t0, counts()))
    (card_hist, card_s, launched), (cpu_hist, cpu_s, _) = runs
    card, cpu = ([h["loss"] for h in hist] for hist in (card_hist, cpu_hist))
    free_diff = float(np.abs(np.asarray(card) - np.asarray(cpu)).max())
    acc = [h["eval_acc"] for h in card_hist]

    data = prepare_single(g, x, layouts=("bucketed",), device=dev)
    data_cpu = prepare_single(g, x, layouts=("bucketed",), device="cpu")
    p = M.to_device(params, dev)
    opt, rnd, steps = adamw_init(p), draws(), []
    to_cpu = lambda t: t.cpu()
    for e in range(SINGLE_EPOCHS):
        opt_cpu = AdamWState(opt.step, tree_map(to_cpu, opt.mu), tree_map(to_cpu, opt.nu))
        _, _, on_cpu = single_train_step(tree_map(to_cpu, p), opt_cpu, cfg, data_cpu, rnd, e)
        p, opt, on_card = single_train_step(p, opt, cfg, data, rnd, e)
        steps.append((float(on_card["loss"]), float(on_cpu["loss"])))
    step_diff = max(abs(a - b) for a, b in steps)

    p = M.to_device(params, dev)
    opt, rnd, ms = adamw_init(p), GeneratorRandomness(0), []
    for e in range(SINGLE_EPOCHS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, opt, _ = single_train_step(p, opt, cfg, data, rnd, e)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    wall, busy_s, by_name = profile_device(
        lambda: single_train_step(p, opt, cfg, data, rnd, SINGLE_EPOCHS + 1))
    print(f"[{label}] {g.num_nodes} nodes, {cfg.model} x{cfg.num_layers} dims "
          f"{cfg.dims()}, {SINGLE_EPOCHS} epochs with an eval after each: card losses "
          f"{card}, eval accuracy {acc}; train_gcn_single wall {card_s:.3f} s "
          f"(card, draws made on the CPU), {cpu_s:.3f} s (CPU)", flush=True)
    print(f"[{label}] card vs CPU, step by step from the card's state: losses "
          f"{steps}, max diff {step_diff:.3e} (bar {TOL}); free-running: CPU losses "
          f"{cpu}, max diff {free_diff:.3e} (recorded, no bar); step-by-step card "
          f"losses equal the main path's bitwise: "
          f"{[a for a, _ in steps] == card}", flush=True)
    print(f"[{label}] single_train_step ms (CUDA-synchronized host clock, draws on "
          f"the card): {', '.join(f'{v:.3f}' for v in ms)} (the first builds the "
          f"kernel tables)", flush=True)
    if by_name:
        print(f"[{label}] profiled step: wall {wall * 1e3:.3f} ms, device busy "
              f"{busy_s * 1e3:.3f} ms ({busy_s / wall:.2%}); top: " + "; ".join(
                  f"{sec * 1e3:.3f} ms {name[:60]}" for name, sec in
                  sorted(by_name.items(), key=lambda kv: -kv[1])[:4]), flush=True)
    per_epoch = {k: v / SINGLE_EPOCHS for k, v in launched.items()}
    print(f"[{label}] kernel launches on the main path: " + ", ".join(
        f"{k} {v} ({per_epoch[k]:.2f} per epoch)" for k, v in launched.items()),
        flush=True)
    if not all(math.isfinite(v) for v in card) or step_diff > TOL:
        fail(f"{label}: card and CPU losses from the same state differ by {step_diff}")
    if launched["seg_aggregate"] <= 0 or (cfg.model != "gat"
                                          and launched["seg_aggregate_backward"] <= 0):
        fail(f"{label}: the main path launched no seg_aggregate kernel, forward or "
             "backward")
    return {"losses": card, "cpu_losses": cpu, "step_losses": steps,
            "max_step_diff": step_diff, "max_free_run_diff": free_diff, "eval_acc": acc,
            "epoch_ms": ms, "launches": launched, "data": data}


def c2_plain_aggregation(g, x, cfg, dev, single: dict) -> dict:
    """ROADMAP C2: phase 9's free-running run repeated on the card with the
    plain aggregation (``bucketed_forward_ref``) in place of the kernel,
    forward and backward, from the same parameters and draws; its gap to
    the CPU run beside the kernel's. The wrapper's dispatch is replaced for
    this run only and restored after it."""
    import numpy as np
    import torch

    from repro_torch.core import GeneratorRandomness, train_gcn_single
    from repro_torch.core import model as M
    from repro_torch.kernels import seg_aggregate as sa

    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    kernel = sa._bucketed_forward
    sa._bucketed_forward = (lambda x, ell, out_rows, backward=False:
                            sa.bucketed_forward_ref(x, ell, out_rows))
    try:
        reset_counts()
        _, hist = train_gcn_single(g, x, cfg, SINGLE_EPOCHS, log_every=1, device=dev,
                                   params=params,
                                   randomness=GeneratorRandomness(0, draw_device="cpu"))
        launched = counts()
    finally:
        sa._bucketed_forward = kernel
    if launched["seg_aggregate"] or launched["seg_aggregate_backward"]:
        fail("the plain-aggregation run launched the kernel")
    plain = np.asarray([h["loss"] for h in hist])
    cpu, card = np.asarray(single["cpu_losses"]), np.asarray(single["losses"])
    r = {"plain_losses": plain.tolist(),
         "plain_vs_cpu": float(np.abs(plain - cpu).max()),
         "kernel_vs_cpu": single["max_free_run_diff"],
         "plain_vs_kernel": float(np.abs(plain - card).max())}
    print(f"[c2] single sage, {SINGLE_EPOCHS} epochs free-running: card with the plain "
          f"aggregation {r['plain_losses']}; gap to the CPU: plain {r['plain_vs_cpu']:.3e}, "
          f"kernel {r['kernel_vs_cpu']:.3e}; plain vs kernel on the card "
          f"{r['plain_vs_kernel']:.3e}", flush=True)
    if not np.all(np.isfinite(plain)):
        fail("the plain-aggregation run's losses are not finite")
    return r


def single_kernel_numbers(data, g, dev) -> dict:
    """The one-graph training layout at F=256: the forward over ``ell``
    and the backward over ``ell_t`` (autograd through the kernel) against
    the plain versions; each layout's times beside its bound and
    torch.sparse.mm's."""
    import torch

    from repro_torch.graph.structure import transpose_csr
    from repro_torch.kernels import seg_aggregate as sa

    csr = g.mean_normalized().csr_by_dst()
    n = csr.num_rows
    x = torch.randn((n, 256), device=dev, requires_grad=True)
    y = sa.bucketed_aggregate(x, data.ell, ell_t=data.ell_t)
    grad = torch.randn_like(y)
    (dx,) = torch.autograd.grad(y, x, grad)
    err = max(max_err(y, sa.bucketed_forward_ref(x.detach(), data.ell, n)),
              max_err(dx, sa.bucketed_forward_ref(grad, data.ell_t, n)))
    x = x.detach()
    fwd = operator_numbers("single-device forward (ell) F=256", x, data.ell, csr, n, n)
    bwd = operator_numbers("single-device backward (ell_t) F=256", x, data.ell_t,
                           transpose_csr(csr), n, n)
    for r in (fwd, bwd):
        r["max_abs_err"] = max(r["max_abs_err"], err)
    return {"forward": fwd, "backward": bwd}


def gat_serve_parity(dev) -> dict:
    """GAT (one head: 47 classes) served on serve_products_paper at full
    fanout: 8 single-node requests in one dispatch, bitwise against the
    full-batch forward; counts reset just before serving, read just after."""
    import numpy as np

    from repro_torch.configs.serve_products_paper import serve_products_paper
    from repro_torch.serve import build_server

    server = build_server(serve_products_paper("model.model=gat", "model.gat_heads=1",
                                               "serve.fanouts=full"), device=dev)
    targets = [int(v) for v in np.random.default_rng(4).integers(
        0, server.graph.num_nodes, BATCH)]
    reset_counts()
    served = np.concatenate(server.serve_batch([[t] for t in targets]))
    launched = counts()
    full = server.full_batch_logits()[np.asarray(targets)]
    bitwise = bool(np.array_equal(served, full))
    print(f"[gat serve] {server.cfg.model} x{server.cfg.num_layers} heads "
          f"{server.cfg.gat_heads} dims {server.cfg.dims()}, {BATCH} requests in "
          f"{server.batches_dispatched} dispatch (shape classes "
          f"{server.shape_classes()}): served vs full-batch logits bitwise {bitwise}, "
          f"max abs diff {float(np.abs(served - full).max()):.3e}; seg_aggregate "
          f"launches {launched['seg_aggregate']}", flush=True)
    if not bitwise or not np.all(np.isfinite(served)):
        fail("GAT served logits differ from the full-batch forward")
    if launched["seg_aggregate"] <= 0:
        fail("GAT serving launched no seg_aggregate kernel")
    return {"launches": launched}


def ckpt_phase(dev) -> dict:
    """train_products_paper: 4 epochs uninterrupted against 2 epochs
    checkpointed and a fresh session resumed to 4 (losses and state bit
    for bit); then serve_products_paper from the checkpoint at full fanout
    (parameters equal to the trained ones, served logits equal to the
    full-batch forward, bit for bit). Counts are reset before the resumed
    run and read after the served batch."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.ckpt import _flatten
    from repro_torch.configs.serve_products_paper import serve_products_paper
    from repro_torch.configs.train_products_paper import train_products_paper
    from repro_torch.run import build_session
    from repro_torch.serve import build_server

    def same(a, b) -> bool:
        fa, fb = _flatten(a), _flatten(b)
        return sorted(fa) == sorted(fb) and all(np.array_equal(fa[k], fb[k]) for k in fa)

    full = build_session(train_products_paper("exec.epochs=4"), device=dev)
    hist = full.fit(log_every=1)
    with tempfile.TemporaryDirectory() as d:
        build_session(train_products_paper("exec.epochs=2", "exec.ckpt_every=2"),
                      device=dev).fit(log_every=1, ckpt_dir=d)
        mgr = CheckpointManager(d)
        npz = mgr.path_for(2).with_suffix(".npz")
        mb = npz.stat().st_size / 1e6
        resumed = build_session(train_products_paper("exec.epochs=4", "exec.ckpt_every=2"),
                                device=dev)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed.trainer.restore_train_state_from(mgr)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        tail = resumed.fit(log_every=1, ckpt_dir=d, resume=True)
        t0 = time.perf_counter()
        resumed.trainer.save_train_state(CheckpointManager(Path(d) / "timed"))
        save_s = time.perf_counter() - t0
        state_equal = same(resumed.trainer.train_state(), full.trainer.train_state())
        print(f"[ckpt] train_products_paper: uninterrupted losses "
              f"{[h['loss'] for h in hist]}; resumed from epoch 2: "
              f"{[h['loss'] for h in tail]}; losses and eval bitwise "
              f"{tail == hist[2:]}, state (params, AdamW, halo cache) bitwise "
              f"{state_equal}", flush=True)
        print(f"[ckpt] checkpoint {mb:.3f} MB ({len(_flatten(full.trainer.train_state()))} "
              f"arrays); save {save_s:.3f} s, restore {restore_s:.3f} s (host clock, "
              f"temp dir)", flush=True)
        if tail != hist[2:] or not state_equal:
            fail("the resumed run differs from the uninterrupted one")
        del full
        server = build_server(serve_products_paper(f"serve.ckpt={d}", "serve.fanouts=full"),
                              device=dev)
        if not same(server.params, resumed.trainer.params):
            fail("the server's restored parameters differ from the trained ones")
        targets = [int(v) for v in np.random.default_rng(5).integers(
            0, server.graph.num_nodes, 4)]
        served = np.concatenate(server.serve_batch([[t] for t in targets]))
        launched = counts()
        bitwise = bool(np.array_equal(served, server.full_batch_logits()[targets]))
    print(f"[ckpt] serve_products_paper from the checkpoint: parameters equal to "
          f"the trained ones bitwise; 4 requests at full fanout vs the full-batch "
          f"forward bitwise {bitwise}", flush=True)
    print(f"[ckpt] kernel launches (resumed epochs 3-4 with evals, then the served "
          f"batch): " + ", ".join(f"{k} {v}" for k, v in launched.items()), flush=True)
    if not bitwise:
        fail("logits served from the checkpoint differ from the full-batch forward")
    for k, v in launched.items():
        if v <= 0:
            fail(f"the checkpoint phase launched no {k} kernel")
    return {"launches": launched, "mb": mb, "save_s": save_s, "restore_s": restore_s}


# -- phases 12 and 13: multi-process training and recovery on the card ----------

MP_RANKS = 8


def rank_draw_cost(dev) -> dict:
    """What drawing the stacked shape costs a rank: one epoch's draws of
    train_products_paper (label propagation, dropout per layer, the Int2
    inter wire's forward and backward uniforms per layer) at the stacked
    shape [8, ...], as each rank draws them, against its own row's shape."""
    import torch

    from repro_torch.core import GeneratorRandomness

    rnd = GeneratorRandomness(0)
    rows, wire, dims = 2239, 3504, (100, 256, 256)

    def epoch(p):
        rnd.lp_select(0, (p, rows), 0.5, dev)
        for l, f in enumerate(dims):
            rnd.dropout_keep(0, l, (p, rows, f), 0.5, dev)
            for backward in (False, True):
                rnd.quant_uniform(0, l, 1, backward, (p, wire, f), dev)

    out = {}
    for p in (MP_RANKS, 1):
        epoch(p)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            epoch(p)
        torch.cuda.synchronize()
        out[p] = (time.perf_counter() - t0) / 5 * 1e3
    print(f"[multiproc] one rank's draws for an epoch (host clock, synchronized): "
          f"stacked shape [8, ...] {out[MP_RANKS]:.3f} ms, its own row [1, ...] "
          f"{out[1]:.3f} ms", flush=True)
    return {"stacked_ms": out[MP_RANKS], "own_row_ms": out[1]}


def check_rank_kernels(rt, dev) -> dict:
    """Every kernel of the multiproc path at the shapes a rank gives it,
    before the fleet starts. seg_aggregate forward and backward on each
    rank's ``[1, ...]`` slice of the ten training layouts, built from the
    runtime's store arrays as the rank builds them: two launches bitwise,
    bitwise equal to that rank's row of one stacked launch, and within
    rtol = atol = TOL of the plain version. quant_pack and dequant_unpack
    on the rows each quantized stage of a rank covers (the psum-scattered
    [G*s, F] shard of the grouped inter stage) at every layer's width:
    bitwise equal to the plain versions."""
    import numpy as np
    import torch

    from repro_torch.kernels import seg_aggregate as sa
    from repro_torch.launch.multiproc import _rank_ell

    arrays, meta = rt._arrays, rt._meta
    m = arrays["x"].shape[1]
    layouts = [("local", "ell", meta["ell_ks"], m, m, False),
               ("local_t", "ellt", meta["ellt_ks"], m, m, True)]
    for level, ks in meta["plans"].items():
        wire, pre = meta["wire_rows"][level], f"plan.{level}"
        layouts += [(f"{level} pre", f"{pre}.pell", ks["pell_ks"], m, wire, False),
                    (f"{level} pre_t", f"{pre}.pellt", ks["pellt_ks"], wire, m, True),
                    (f"{level} receive", f"{pre}.rell", ks["rell_ks"], wire, m, False),
                    (f"{level} receive_t", f"{pre}.rellt", ks["rellt_ks"], m, wire,
                     True)]
    worst = {"seg_aggregate": 0.0, "seg_aggregate_backward": 0.0}
    for name, prefix, ks, n_in, n_out, bwd in layouts:
        stacked = sa.device_bucketed(
            [(k, *(arrays[f"{prefix}.{i}.{a}"] for a in ("rows", "idx", "w")))
             for i, k in enumerate(ks)], device=dev, squeeze=False)
        for f in sorted(set(meta["feat_dims"])):
            x = torch.randn((rt.nprocs, n_in, f), device=dev)
            whole = sa._bucketed_forward(x, stacked, n_out, backward=bwd)
            for r in range(rt.nprocs):
                lay = _rank_ell(arrays, prefix, ks, r, dev)
                xr = x[r:r + 1].contiguous()
                y = sa._bucketed_forward(xr, lay, n_out, backward=bwd)
                if not torch.equal(y, sa._bucketed_forward(xr, lay, n_out, backward=bwd)):
                    fail(f"rank {r} {name} F={f}: two launches differ")
                if not torch.equal(y[0], whole[r]):
                    fail(f"rank {r} {name} F={f}: differs from its row of the "
                         "stacked launch")
                k = "seg_aggregate_backward" if bwd else "seg_aggregate"
                worst[k] = max(worst[k], max_err(y, sa.bucketed_forward_ref(xr, lay, n_out)))
    print(f"[multiproc] seg_aggregate forward and backward on every rank's [1, ...] "
          f"slice of the {len(layouts)} training layouts at F in "
          f"{sorted(set(meta['feat_dims']))}: two launches bitwise, bitwise equal to "
          f"the rank's row of the stacked launch; max abs err to the plain version "
          f"{worst['seg_aggregate']:.3e} forward, {worst['seg_aggregate_backward']:.3e} "
          f"backward (rtol=atol={TOL})", flush=True)

    rng = np.random.default_rng(12)
    shapes = []
    worst.update(quant_pack=0.0, dequant_unpack=0.0)
    for stage in rt.schedule.stages:
        if not stage.bits:
            continue
        topo = rt.schedule.topo(stage)
        rows = meta["wire_rows"][stage.level]
        qrows = rows if topo.kind == "a2a" else rows // topo.shard_size
        for f in sorted(set(meta["feat_dims"])):
            x = torch.from_numpy(rng.normal(size=(qrows, f)).astype(np.float32)).to(dev)
            u = torch.from_numpy(rng.uniform(size=(qrows, f)).astype(np.float32)).to(dev)
            for k, e in zip(("quant_pack", "dequant_unpack"),
                            compare_quant(x, u, stage.bits, f)):
                worst[k] = max(worst[k], e)
            shapes.append((stage.level, qrows, f, stage.bits))
    if not shapes:
        fail("multiproc: the schedule quantizes no stage")
    print(f"[multiproc] quant_pack and dequant_unpack equal their plain versions "
          f"bitwise at each rank's quantized shapes (level, rows, F, bits) {shapes}",
          flush=True)
    return {"max_abs_err": worst, "quant_shapes": shapes, "layouts": len(layouts)}


def multiproc_phase(dev, stacked: dict) -> dict:
    """train_products_paper as 8 processes sharing the card
    (exec.mode=multiproc): 4 epochs and one evaluation, held to phase 7's
    stacked run from the same parameters and draws (epoch 0 within TOL,
    the rest within phase 8's Int2 bar, 1e-3). Every rank must launch
    every kernel; no segment may leak."""
    import math

    import torch

    from repro_torch.configs.train_products_paper import train_products_paper
    from repro_torch.launch.shm_store import leaked_segments
    from repro_torch.run import build_session

    torch.cuda.empty_cache()
    spec = train_products_paper("exec.mode=multiproc", f"exec.nprocs={MP_RANKS}")
    session = build_session(spec, device=dev)
    rt = session.trainer
    try:
        print(f"[multiproc] {spec.describe()}: {rt.dry_plan()}", flush=True)
        checked = check_rank_kernels(rt, dev)
        torch.cuda.empty_cache()
        epochs = []
        for _ in range(TRAIN_EPOCHS):
            t0 = time.perf_counter()
            m = session.train_epoch()
            m["ms"] = (time.perf_counter() - t0) * 1e3
            epochs.append(m)
        acc = session.evaluate()
        smry = rt.summary()
        stats, eval_launches = list(rt.epoch_stats), rt.eval_launches
        ready, token = rt.ready_stats, rt.token
    finally:
        session.close()
    leaked = leaked_segments(token)
    ref = [m["loss"] for m in stacked["epochs"]]
    losses = [m["loss"] for m in epochs]
    diffs = [abs(a - b) for a, b in zip(losses, ref)]
    for i, (m, st) in enumerate(zip(epochs, stats)):
        kind = "refresh" if i % 2 == 0 else "stale"
        print(f"[multiproc] epoch {i} ({kind} inter wire): loss {m['loss']:.9f} "
              f"(stacked {ref[i]:.9f}, diff {diffs[i]:.3e}); {m['ms']:.3f} ms on the "
              f"host clock{' (includes spawning the fleet)' if i == 0 else ''}, slowest "
              f"rank {st['epoch_s'] * 1e3:.3f} ms; per rank: host seconds in mailbox "
              f"rounds (wire_s) {[round(w, 6) for w in st['wire_s']]}, of them waiting "
              f"on peers (wait_s) {[round(w, 6) for w in st['wait_s']]}; wire_bytes "
              f"{st['wire_bytes']}", flush=True)
    print(f"[multiproc] eval accuracy {acc:.4f} (stacked {stacked['eval_acc']:.4f})",
          flush=True)
    per_rank = []
    for r in range(MP_RANKS):
        total = {k: sum(st["launches"][r][k] for st in stats) + eval_launches[r][k]
                 for k in eval_launches[r]}
        per_rank.append(total)
    launched = {k: sum(t[k] for t in per_rank) for k in per_rank[0]}
    print(f"[multiproc] kernel launches on the multiproc path (4 epochs + eval), per "
          f"rank: {per_rank[0]} (rank 0); all ranks: {launched}", flush=True)
    for r in ready:
        print(f"[multiproc] rank {r['rank']} RSS before attach "
              f"{r['rss_before_attach'] / 1e6:.1f} MB, after attach "
              f"{r['rss_after_attach'] / 1e6:.1f} MB, after its slices "
              f"{r['rss_after_slices'] / 1e6:.1f} MB", flush=True)
    for r in smry["ranks"]:
        mem = ("device memory not measured (not on the card)" if "device_bytes" not in r
               else f"device memory allocated {r['device_bytes'] / 1e6:.1f} MB, peak "
               f"{r['device_peak_bytes'] / 1e6:.1f} MB, reserved "
               f"{r['device_reserved_bytes'] / 1e6:.1f} MB")
        print(f"[multiproc] rank {r['rank']} at the end: RSS {r['rss_now'] / 1e6:.1f} MB; "
              f"{mem}; wait_s {r['wait_s']:.6f}, wire_s {r['wire_s']:.6f}, "
              f"wire_bytes {r['wire_bytes']}", flush=True)
    print(f"[multiproc] shared store {smry['store_bytes']} B in one copy, mailboxes "
          f"{smry['mailbox_bytes']} B; parent RSS {smry['parent_rss'] / 1e6:.1f} MB; "
          f"leaked segments {leaked}", flush=True)
    if not all(math.isfinite(v) for v in losses):
        fail(f"multiproc: non-finite losses {losses}")
    if diffs[0] > TOL or max(diffs[1:]) > 1e-3:
        fail(f"multiproc losses differ from the stacked run's: {diffs} (bars {TOL} "
             "at epoch 0, 1e-3 after)")
    for r, total in enumerate(per_rank):
        for k, v in total.items():
            if v <= 0:
                fail(f"multiproc: rank {r} launched no {k} kernel")
    stale = [st["wire_bytes"][0] for st in stats]
    if not stale[1] < stale[0]:
        fail(f"multiproc: a stale epoch wrote no fewer wire bytes than a refresh: {stale}")
    if leaked:
        fail(f"multiproc: leaked shared-memory segments {leaked}")
    return {"losses": losses, "diffs": diffs, "epochs": epochs, "stats": stats,
            "eval_acc": acc, "launches": launched, "per_rank": per_rank,
            "checked": checked}


def recovery_phase(dev, uninterrupted: dict) -> dict:
    """A chaos kill of rank 3 at the start of epoch 3 (after 2 completed),
    with a checkpoint every epoch, against phase 12's uninterrupted run:
    losses bitwise, no segment leaked."""
    import tempfile

    from repro_torch.configs.train_products_paper import train_products_paper
    from repro_torch.launch.chaos import evaluate_case, run_faulted

    spec = train_products_paper("exec.mode=multiproc", f"exec.nprocs={MP_RANKS}",
                                f"exec.epochs={TRAIN_EPOCHS}", "exec.ckpt_every=1",
                                "exec.max_restarts=2")
    with tempfile.TemporaryDirectory() as d:
        obs = run_faulted(spec, "kill", rank=3, at_epoch=2, ckpt_dir=d, device=dev)
    case = evaluate_case("kill", 3, 2, uninterrupted["losses"], obs, 0.0)
    print(f"[recovery] kill of rank 3 after epoch 2: detected {case['detection_kind']} "
          f"in {case['detection_latency_s']} s, respawn {case['respawn_s']} s, restore "
          f"{case['restore_s']} s (step {case['restore_step']}), run {case['wall_s']} s; "
          f"losses {case['faulted_losses']} vs uninterrupted {uninterrupted['losses']}: "
          f"max diff {case['max_loss_delta']}; leaked {case['leaked_segments']}; "
          f"checks {case['checks']}", flush=True)
    if not case["ok"]:
        fail(f"recovery on the card: {case['checks']} (error {case['error']})")
    return case


def wire_only(tree: Path, dev, smi: str) -> None:
    """``--wire TREE``: build TREE's kernels and run phase 6 on them alone,
    so that two trees (a parent and its change) are timed by one harness
    in one call on one card."""
    sys.path.insert(0, str(tree.resolve() / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import quant_pack as qp

    if not Path(qp.__file__).resolve().is_relative_to(tree.resolve()):
        fail(f"--wire {tree}: imported repro_torch from {qp.__file__}")
    libs = build.build_all()
    print(f"[build] {tree}: {', '.join(p.name for p in libs)}", flush=True)
    print_ptxas(build.build_logs)
    wire = check_quant_kernels(dev)
    print(json.dumps({"tree": str(tree), "wire": wire}))
    print(smi)


def experiments(dev, smi: str) -> None:
    """``--experiments``: the two one-off measurements whose readings
    PERF.md keeps, outside the smoke's phases: ROADMAP C2's
    plain-aggregation run (after phase 9's SAGE run, which it is compared
    with) and what drawing the stacked shape costs a rank."""
    from repro_torch.configs.graphsage_paper import PAPER_PRESETS, gcn_config
    from repro_torch.kernels import build

    build.build_all()
    g, x = preset_graph("ogbn-products")
    cfg = gcn_config(PAPER_PRESETS["ogbn-products"])
    single = single_phase("single sage", g, x, cfg, dev)
    c2_plain_aggregation(g, x, cfg, dev, single)
    rank_draw_cost(dev)
    print(smi)


def print_ptxas(logs: dict) -> None:
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)


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
    if sys.argv[1:2] == ["--wire"]:
        return wire_only(Path(sys.argv[2]) if len(sys.argv) > 2 else ROOT, dev, smi)
    if sys.argv[1:2] == ["--experiments"]:
        return experiments(dev, smi)

    from repro_torch.configs.serve_products_paper import serve_products_paper
    from repro_torch.configs.train_products_paper import train_products_paper
    from repro_torch.kernels import build
    from repro_torch.run import build_session
    from repro_torch.serve import build_server

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[build] {len(libs)} kernel libraries in {time.perf_counter() - t0:.2f} s: "
          f"{', '.join(p.name for p in libs)}", flush=True)
    print_ptxas(build.build_logs)

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
    del server

    wire = check_quant_kernels(dev)

    t0 = time.perf_counter()
    tspec = train_products_paper()
    session = build_session(tspec, device=dev)
    wd = session.wd
    print(f"[train] built {tspec.describe()} in {time.perf_counter() - t0:.2f} s: "
          f"{session.graph.num_nodes} nodes, {session.graph.num_edges} edges, "
          f"x {tuple(wd.x.shape)}, dims {session.trainer.cfg.dims()}, schedule "
          f"{session.schedule.describe()}", flush=True)
    agg = check_train_kernels(session, dev)
    pre_aggregation_repeats(session, dev)
    trained = train_main_path(session)
    del session
    coo_phase(dev)
    train_parity(dev)

    from repro_torch.configs.graphsage_paper import PAPER_PRESETS, gcn_config

    g, x = preset_graph("ogbn-products")
    single = single_phase("single sage", g, x, gcn_config(PAPER_PRESETS["ogbn-products"]),
                          dev)
    single_agg = single_kernel_numbers(single.pop("data"), g, dev)
    g, x = preset_graph("ogbn-arxiv")
    gat = single_phase("single gat", g, x,
                       gcn_config(PAPER_PRESETS["ogbn-arxiv"], model="gat"), dev)
    del gat["data"], g, x
    gat_served = gat_serve_parity(dev)
    ckpt = ckpt_phase(dev)
    multi = multiproc_phase(dev, trained)
    recovery_phase(dev, multi)

    t = timings["serve_F256"]
    launches = trained["launches"]
    kernels = []
    for name, replaces, nums in (
            ("seg_aggregate", "src/repro/kernels/seg_aggregate.py:91", agg["forward"]),
            ("seg_aggregate_backward", "src/repro/kernels/seg_aggregate.py:91",
             agg["backward"]),
            ("quant_pack", "src/repro/kernels/quant_pack.py:63", wire["quant_pack"]),
            ("dequant_unpack", "src/repro/kernels/quant_pack.py:103",
             wire["dequant_unpack"])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": ("src/repro_torch/kernels/csrc/quant_pack.cu" if "quant" in name
                       else "src/repro_torch/kernels/csrc/seg_aggregate.cu"),
            "replaces": replaces, "launches": launches[name],
            **{k: nums[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "launches_per_call",
                                    "ms_after_flush", "F100") if k in nums}})
    for k in kernels:
        k["multiproc_max_abs_err"] = multi["checked"]["max_abs_err"][k["name"]]
    paths = {"serve": {"seg_aggregate": served["launches"]}, "train": launches,
             "single_sage": single["launches"], "single_gat": gat["launches"],
             "gat_serve": gat_served["launches"], "ckpt_resume_serve": ckpt["launches"],
             "multiproc": multi["launches"]}
    for k in kernels:
        k["launches_by_path"] = {path: c.get(k["name"], 0) for path, c in paths.items()}
    for k, nums in zip(kernels, (single_agg["forward"], single_agg["backward"])):
        k["single"] = {"launches": single["launches"][k["name"]],
                       **{f: nums[f] for f in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms",
                                                "launches_per_call")}}
    kernels[0]["serve"] = {"launches": served["launches"],
                           "max_abs_err": max(worst, *(v["max_abs_err"]
                                                       for v in timings.values())),
                           **{k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms",
                                                "launches_per_call")}}
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
