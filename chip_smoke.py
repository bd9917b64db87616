#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --wire [TREE]   # phases 1, 2 and 6 only, on the
                                          # kernels of the checkout at TREE
    python3 chip_smoke.py --experiments   # phase 9's SAGE run, then ROADMAP
                                          # C2's plain-aggregation run and a
                                          # rank's cost of the stacked draws
    python3 chip_smoke.py --tune          # phases 1, 2 and 14 only
    python3 chip_smoke.py --lm            # phases 1, 2 and 15 only
    python3 chip_smoke.py --lm-train      # phases 1, 2 and 16 only
    python3 chip_smoke.py --dryrun        # phases 1, 2 and 17 only
    python3 chip_smoke.py --lm-dryrun     # phases 1, 2 and 18 only
    python3 chip_smoke.py --shard-map     # phases 1, 2 and 19 only (with
                                          # phase 7's stacked run and phase
                                          # 12 as its references)
    python3 chip_smoke.py --time [TREE]   # phase 4's burst and phase 7's
                                          # epochs, longer, on the checkout
                                          # at TREE (for parent/change A/B)

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
             atol = 1e-5). On all fourteen stacked layouts (local graph,
             intra and inter send gathers, send-side pre-aggregations and
             receive scatters, and the reverse of each), at F in (100,
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
14. audit and tune — at the full width of train_products_paper, on the
             card: the spec matrix (run.matrix over specs/: 8 ok, the two
             shard_map specs lowered as their ranks' own programs, 8 and 4
             of them, multiproc's dry plan, the serve spec served); the
             audit gate over specs/ and the AST lint over src/repro_torch
             (zero findings; the shard_map specs audited on their rank
             programs, skipping no rule their stacked stand-in ran); each
             shard_map spec's rank programs lowered on the card (ops and
             collectives per rank, seconds); the audit of
             train_products_paper (five rules run, zero findings) with its
             recorded all-to-all bytes per worker beside the prediction, per
             stage; the audit-gated tuner (run.tune over DEFAULT_AXES, top 3,
             interleaved stacked probes of whole delay periods, the host's
             measured HardwareSpec): modelled rows, rejected candidates,
             measured against modelled epoch ms and the calibration; the
             result JSON under build/; then 2 epochs with exec.auto set to it
             against 2 epochs of the winner's spec written out: losses and
             parameters bitwise, the schedule the winner's. Launch counts are
             reset just before and read just after: seg_aggregate, its
             backward and (when a shortlisted schedule quantizes) the
             quantizer pair must have launched. Then, outside the counts,
             every kernel against its plain version on the layouts of each
             shortlisted candidate and each training spec of specs/ (flat
             and hierarchical; a tuned partition builds other buckets; the
             shard_map specs also at their ranks' shapes, phase 12's check):
             seg_aggregate forward and backward at F in (100, 256, 47) within
             1e-5 and two launches bitwise, the quantizer pair bitwise at
             each quantized stage's wire rows.
15. LM serving — the port's entry point (launch/serve_llm: build_lm,
             generate) on the card for tinyllama-1.1b (all 22 layers),
             granite-moe-1b-a400m (all 24 layers, 32 experts, top-8),
             deepseek-v2-lite-16b (full width, the first 4 of 27 layers),
             zamba2-2.7b (all 54 Mamba2 layers, the shared attention block
             every 6th), xlstm-350m (all 24 layers: 6 groups of 3 mLSTM + 1
             sLSTM) and whisper-small (12 + 12 layers, 1500 frames drawn
             from seed 0 and encoded into the cross K/V in each prefill),
             random weights from a seed, fp32 with a bf16 copy. Each runs
             the default mix (batch 4, prompt 12 token by token, 24
             generated greedily) twice: prefill seconds, decode ms per step
             and tokens/s of the second run, peak device memory above what
             earlier phases hold, and the decode bound (the bf16 weights a
             step reads, its routed experts as the run selected them, its
             K/V caches, whisper's cross K/V, the recurrent states read and
             written, over 3.35 TB/s); every logit finite; the second run
             bitwise equal to the first. Then, within the bf16 bar x
             max|logit| (serve_llm.bf16_bar: 2e-2; by depth zamba2 5e-2 at
             6 layers and 0.15 at 54, xLSTM 4e-2 at 4 and 8e-2 at 24,
             whisper 3e-2 at 12, about twice the reference's own): the
             first layers at full width (2; whisper 2 + 2; zamba2 6, so the
             shared block runs; xLSTM one group of 4), 12 teacher-forced
             tokens, on the card against the CPU with the same weights; and
             every prompt position's decode logits against forward_train on
             the card (for MoE at a capacity that drops no assignment, as
             decode drops none; the shipped capacity's drops are printed
             beside it); and again in fp32 (the fp32 parameters) within
             serve_llm.FP32_BAR (1e-5) x max|logit|: rounding that small
             flips hardly a tie, so it holds the tokens bf16 flips leave
             out. A token whose experts differ between two bf16 runs (a
             near-tie that rounding flips) is counted and printed, and it
             and the later positions of its sequence are left out of the
             bar; a flip no lower flip explains must be a near-tie (within
             2e-2 in the reference run's probabilities). One profiled run
             of 5 serve_steps gives the device's busy share.
16. LM training — models.train_step on the card, bf16 compute, fp32
             parameters and AdamW, TF32 off: tinyllama-1.1b (all 22 layers)
             and granite-moe-1b-a400m (all 24, 32 experts top-8, with the
             aux loss) at full width, train_4k's 4096 tokens a sequence,
             batch 8 (cut from 256) in 4 micro-batches of 8192 tokens,
             TokenPipeline batches from seed 0, 5 steps from seed-0
             parameters, twice: every loss finite, the fifth below the
             first, the second run bitwise equal (losses, parameters,
             AdamW state). Step ms of the second run (CUDA-synchronized
             host clock), tokens/s, the model-FLOP share of 989 TFLOP/s
             bf16, peak device memory above what earlier phases hold, the
             busy share and top operations of one profiled step; granite's
             dropped expert assignments at its shipped capacity. The
             kernel launch counts are reset before and read after (the
             path launches none). Then one train_step at
             num_microbatches=2 on the card against the CPU from the same
             parameters and batch, at full width with the first layer
             (tinyllama, granite-moe, deepseek and qwen2-vl with its
             patches 1; zamba2 6 at 256 tokens, so its shared block runs;
             xLSTM 4, one group; whisper 1 + 1): at fp32 the
             loss within 1e-5 relative and every gradient, mu and nu leaf
             within 1e-5 x its tree's max; at bf16 the loss within
             serve_llm.bf16_bar; every gradient finite in both.
17. dry-run — the port's GCN dry-run entry point (launch/dryrun.py --gcn,
             run through its main on the card): the JAX package's
             check-overlap line (rmat-10, 8 workers, 2 groups, Int2,
             --overlap --assert-overlap; the base spec is shard_map, so each
             worker's program is recorded as a rank's own, one rank after
             another on the card), where the overlap flags must read true on
             every rank (the inter all-to-all too) and the overlap-order rule
             find nothing; the same with --no-overlap, where they must read
             false; then the JAX package's default, 256 workers at rmat-13
             (flat, Int2), 256 rank programs. Each record must have status
             ok, a rank program per worker, no unrecorded collective and
             every rank's recorded all-to-all bytes equal to
             predicted_hlo_wire_bytes; its collectives, cost (per worker),
             peak device memory (the session and its recorded steps, above
             what was held before) and seconds are printed. The launch
             counts are reset before the first run and read after the last:
             every kernel must have launched. Then the check line on the
             CPU, whose cost and collectives must equal the card's, and
             every kernel against its plain version at the three runs' rank
             shapes (phase 12's check on every rank, F in (128, 256)) and
             on their stacked layouts, all workers in one launch (phase
             14's check, F in (100, 256, 47, 128)).
18. LM dry-run — the port's LM dry-run entry point (launch/dryrun.py
             --arch/--shape, through its main) on the card for one
             combination of each input shape and each family (whisper-small
             x decode_32k, tinyllama-1.1b x train_4k, granite-moe-1b-a400m x
             prefill_32k, zamba2-2.7b x long_500k, xlstm-350m x decode_32k,
             qwen2-vl-2b x decode_32k): FakeTensorMode traces, so nothing is
             allocated and no kernel launches (the counts are reset before
             and read after: all must read 0). The same records on the CPU
             device must give the same FLOPs, bytes and argument bytes; per
             combination the FLOPs, bytes, the three memory figures and the
             seconds are printed. cost_extrapolate against a full-depth
             trace of granite-moe-1b-a400m x prefill_32k at 4 layers
             (FLOPs exactly, bytes within 1%). Then the live-byte tracker behind
             temp_size_in_bytes on two real steps on the card (whisper-small
             serve_step at batch 16 over a 4096-token cache; tinyllama-1.1b
             train_step over one sequence of 4096 tokens), its peak within
             10% of torch.cuda.max_memory_allocated above what was held;
             the roofline table (launch/roofline.py, H100 constants) over
             the card's records; and the quantized collectives
             (sharding/quantized_collectives.py: psum, all-to-all, tree) at
             P in (4, 8) and bits in (8, 4): the kernels' words, zeros and
             scales bitwise equal to the plain path's on the card, every
             result bitwise equal to the CPU's from the same uniforms, with
             the launches of quant_pack and dequant_unpack counted.
19. shard_map — train_products_paper under exec.mode=shard_map
             (launch/spmd.py: one process per worker, the exchange and the
             gradient sum over torch.distributed collectives) as 2x4 ranks
             over gloo on the one card (backend="gloo": the rank logic on
             device tensors, every buffer staged through host memory by
             gloo, so its times are host-staged, not NCCL's), from phase
             7's parameters and draws. Every kernel is held at a rank's
             shapes first (phase 12's check). 4 epochs and an evaluation:
             losses bitwise equal to phase 12's multiproc losses and within
             phase 12's bars of phase 7's stacked ones; every rank launches
             every kernel (per-rank counts printed); a stale epoch moves
             fewer wire bytes than a refresh; per-rank epoch ms, host
             seconds in the wire and in Work.wait, wire bytes. Then the
             fleet restores its epoch-0 checkpoint and runs again: bitwise.
             Then the ranks' programs lowered at epoch 0 in this process
             (Session.lower: the fake backend, every rank on the card): per
             rank, the bytes its recorded collectives deliver must equal
             the wire_bytes the real rank reported for epoch 0, every
             kernel must launch, and every rank posts its inter all-to-all
             before its local aggregation.
             Then NCCL over the visible cards, each against the stacked run
             of its spec under the same bars, every rank launching every
             kernel: a flat P = 1 Int2 variant on any card (each collective
             a self-send); with 4 cards or more, the 2x2 flagship schedule
             with one rank a card.
20. the kernels line (JSON, with each kernel's launches on every path), the
             nvidia-smi line, and the result line.
"""

from __future__ import annotations

import json
import math
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
    """The stacked layouts of the training path: (name, layout, source
    rows, output rows, whether it is a backward layout). Fourteen for a
    hierarchical schedule, eight for a flat one."""
    wd = session.wd
    m = wd.x.shape[1]
    out = [("local", wd.ell, m, m, False), ("local_t", wd.ell_t, m, m, True)]
    plans = ((("flat", wd.plan),) if wd.hier_plan is None else
             (("intra", wd.hier_plan.intra), ("inter", wd.hier_plan.inter)))
    for name, plan in plans:
        wire = plan.send_gather_idx.shape[1]
        out += [(f"{name} send", plan.send_ell, m, wire, False),
                (f"{name} send_t", plan.send_ell_t, wire, m, True),
                (f"{name} pre", plan.pre_ell, m, wire, False),
                (f"{name} pre_t", plan.pre_ell_t, wire, m, True),
                (f"{name} receive", plan.recv_ell, wire, m, False),
                (f"{name} receive_t", plan.recv_ell_t, m, wire, True)]
    return out


def check_repeats(layouts, dev, verbose: bool = True) -> float:
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
        if verbose:
            print(f"[train] {name}: two launches agree bit for bit at F in "
                  "(100, 256, 47)", flush=True)
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


def check_rank_kernels(rt, dev, tag: str = "multiproc", need_quant: bool = True) -> dict:
    """Every kernel of the multiproc (or shard_map: ``tag``) path at the
    shapes a rank gives it (before the fleet starts, or as ``Session.lower``
    records each rank). seg_aggregate forward and backward on each
    rank's ``[1, ...]`` slice of the ten training layouts, built from the
    runtime's store arrays as the rank builds them: two launches bitwise,
    bitwise equal to that rank's row of one stacked launch, and within
    rtol = atol = TOL of the plain version. quant_pack and dequant_unpack
    on the rows each quantized stage of a rank covers (the psum-scattered
    [G*s, F] shard of the grouped inter stage) at every layer's width:
    bitwise equal to the plain versions; unless ``need_quant`` is false, a
    schedule that quantizes no stage fails. Every rank is checked."""
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
        lays = [_rank_ell(arrays, prefix, ks, r, dev) for r in range(rt.nprocs)]
        for f in sorted(set(meta["feat_dims"])):
            x = torch.randn((rt.nprocs, n_in, f), device=dev)
            whole = sa._bucketed_forward(x, stacked, n_out, backward=bwd)
            for r, lay in enumerate(lays):
                xr = x[r:r + 1].contiguous()
                y = sa._bucketed_forward(xr, lay, n_out, backward=bwd)
                if not torch.equal(y, sa._bucketed_forward(xr, lay, n_out, backward=bwd)):
                    fail(f"rank {r} {name} F={f}: two launches differ")
                if not torch.equal(y[0], whole[r]):
                    fail(f"rank {r} {name} F={f}: differs from its row of the "
                         "stacked launch")
                k = "seg_aggregate_backward" if bwd else "seg_aggregate"
                worst[k] = max(worst[k], max_err(y, sa.bucketed_forward_ref(xr, lay, n_out)))
    print(f"[{tag}] seg_aggregate forward and backward on every rank's [1, ...] slice "
          f"({rt.nprocs} ranks) of the {len(layouts)} training layouts at F in "
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
    if not shapes and need_quant:
        fail(f"{tag}: the schedule quantizes no stage")
    print(f"[{tag}] quant_pack and dequant_unpack equal their plain versions "
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


# -- phase 19: exec.mode=shard_map ------------------------------------------------

# The NCCL variants: a flat P = 1 run on any card (each collective a
# self-send, through the process group, its streams, work handles and the
# autograd Functions); with four cards or more, the 2x2 flagship schedule
# with one rank a card. Each against the stacked run of the same spec.
SM_NCCL = (("flat P = 1, Int2 cd=2", 1, ["partition.groups=0", "partition.nparts=1",
                                           "schedule.inter_bits=null",
                                           "schedule.inter_cd=null", "schedule.bits=2",
                                           "schedule.cd=2"]),
           ("2x2, one rank a card", 4, ["partition.groups=2", "partition.nparts=4"]))


def _timed_epochs(session, n: int) -> list:
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        m = session.train_epoch()
        m["ms"] = (time.perf_counter() - t0) * 1e3
        out.append(m)
    return out


def _rank_launches(stats, eval_launches) -> list:
    """Per rank: each kernel's launches over the epochs of ``stats`` and the
    evaluation."""
    return [{k: sum(st["launches"][r][k] for st in stats) + ev[k] for k in ev}
            for r, ev in enumerate(eval_launches)]


def _print_sm_epochs(tag: str, epochs, stats, ref, label: str) -> None:
    for i, (m, st) in enumerate(zip(epochs, stats)):
        kind = "refresh" if i % 2 == 0 else "stale"
        print(f"[{tag}] epoch {i} ({kind}): loss {m['loss']:.9f} ({label} "
              f"{ref[i]:.9f}, diff {abs(m['loss'] - ref[i]):.3e}); {m['ms']:.3f} ms on the "
              f"host clock; per rank: epoch ms {[round(x * 1e3, 3) for x in st['rank_epoch_s']]}, "
              f"host seconds in the wire (wire_s) {[round(w, 6) for w in st['wire_s']]}, of "
              f"them in Work.wait (wait_s) {[round(w, 6) for w in st['wait_s']]}; wire_bytes "
              f"{st['wire_bytes']}", flush=True)


def shard_map_nccl(dev, label: str, over, cache) -> dict:
    """One NCCL variant: the stacked run of the spec, then the shard_map
    run over NCCL from the same parameters and draws (seed 0), 4 epochs and
    an evaluation; phase 12's bars against the stacked losses; every rank
    must launch every kernel. ``cache`` (a ``run.session.BuildCache``)
    builds the graph and partition once for both runs."""
    import math

    import torch

    from repro_torch.configs.train_products_paper import train_products_paper
    from repro_torch.run import build_session

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stacked = build_session(train_products_paper(*over), device=dev, cache=cache)
    ref = [stacked.train_epoch()["loss"] for _ in range(TRAIN_EPOCHS)]
    ref_acc = stacked.evaluate()
    del stacked
    torch.cuda.empty_cache()
    spec = train_products_paper("exec.mode=shard_map", *over)
    t1 = time.perf_counter()
    session = build_session(spec, device=dev, cache=cache)
    rt = session.trainer
    tag = f"shard_map nccl {label}"
    try:
        print(f"[{tag}] {spec.describe()}: {rt.nprocs} ranks over {rt.backend} on "
              f"{rt.devices}, mesh {rt.mesh.shape}; the stacked reference took "
              f"{t1 - t0:.2f} s", flush=True)
        epochs = _timed_epochs(session, TRAIN_EPOCHS)
        acc = session.evaluate()
        stats, per_rank = list(rt.epoch_stats), _rank_launches(rt.epoch_stats, rt.eval_launches)
    finally:
        session.close()
    losses = [m["loss"] for m in epochs]
    diffs = [abs(a - b) for a, b in zip(losses, ref)]
    _print_sm_epochs(tag, epochs, stats, ref, "stacked")
    print(f"[{tag}] eval accuracy {acc:.4f} (stacked {ref_acc:.4f}); kernel launches per "
          f"rank {per_rank}", flush=True)
    if not all(math.isfinite(v) for v in losses):
        fail(f"{tag}: non-finite losses {losses}")
    if diffs[0] > TOL or max(diffs[1:]) > 1e-3:
        fail(f"{tag}: losses differ from the stacked run's: {diffs} (bars {TOL} at "
             "epoch 0, 1e-3 after)")
    for r, total in enumerate(per_rank):
        for k, v in total.items():
            if v <= 0:
                fail(f"{tag}: rank {r} launched no {k} kernel")
    return {"losses": losses, "diffs": diffs, "stats": stats, "per_rank": per_rank}


def shard_map_phase(dev, stacked: dict, multi: dict) -> dict:
    """Phase 19: train_products_paper under exec.mode=shard_map as 2x4
    ranks over gloo on the card (backend="gloo": the rank logic on device
    tensors, every buffer staged through host memory by gloo), from phase
    7's parameters and draws (seed 0): every kernel held at a rank's
    shapes first; 4 epochs and an evaluation, their losses bitwise phase
    12's multiproc losses and within phase 12's bars of phase 7's stacked
    ones; every rank launches every kernel; a stale epoch moves fewer wire
    bytes than a refresh; then the fleet restores its epoch-0 checkpoint
    and runs again, bitwise. Then NCCL over the visible cards
    (``SM_NCCL``)."""
    import math
    import tempfile

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.train_products_paper import train_products_paper
    from repro_torch.launch.shm_store import leaked_segments
    from repro_torch.run import build_session
    from repro_torch.run.session import BuildCache

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cache = BuildCache()
    spec = train_products_paper("exec.mode=shard_map")
    session = build_session(spec, device=dev, backend="gloo", cache=cache)
    rt = session.trainer
    tag = "shard_map gloo"
    runs = []
    try:
        print(f"[{tag}] {spec.describe()}: {rt.nprocs} ranks over gloo on {rt.devices[0]}, "
              f"mesh {rt.mesh.shape}, built in {time.perf_counter() - t_phase:.2f} s; "
              "host-staged: gloo's CUDA collectives copy every buffer through host "
              "memory, so these times are not NCCL's", flush=True)
        t0 = time.perf_counter()
        checked = check_rank_kernels(rt, dev, tag=tag)
        print(f"[{tag}] kernels checked at a rank's shapes in {time.perf_counter() - t0:.2f} s",
              flush=True)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d)
            t0 = time.perf_counter()
            rt.save_train_state(mgr)          # spawns the fleet; epoch 0
            print(f"[{tag}] fleet up and epoch 0 saved in {time.perf_counter() - t0:.2f} s",
                  flush=True)
            for run in range(2):
                if run:
                    rt.restore_train_state_from(mgr, step=0)
                epochs = _timed_epochs(session, TRAIN_EPOCHS)
                acc = session.evaluate()
                runs.append({"epochs": epochs, "acc": acc,
                             "stats": list(rt.epoch_stats[-TRAIN_EPOCHS:]),
                             "per_rank": _rank_launches(rt.epoch_stats[-TRAIN_EPOCHS:],
                                                        rt.eval_launches)})
        # The ranks' own programs, lowered in this process (the fake
        # backend, every rank on this card; the fleet is not involved).
        before = counts()
        t0 = time.perf_counter()
        lowered = session.lower(epoch=0)
        torch.cuda.synchronize()
        lower_s = time.perf_counter() - t0
        lower_launches = {k: v - before[k] for k, v in counts().items()}
        smry = rt.summary()
        token = rt.token
    finally:
        session.close()
    leaked = leaked_segments(token)
    first = runs[0]
    lowered_bytes = [p.wire_bytes() for p in lowered.programs]
    print(f"[{tag}] lowered the {len(lowered.programs)} ranks' programs at epoch 0 on the "
          f"card in {lower_s:.3f} s: ops per rank {[len(p.ops) for p in lowered.programs]}, "
          f"collectives per rank {[len(p.collectives()) for p in lowered.programs]}; "
          f"bytes the recorded collectives deliver per rank {lowered_bytes}, the ranks' "
          f"wire_bytes in epoch 0 {first['stats'][0]['wire_bytes']}; kernel launches "
          f"while lowering {lower_launches}", flush=True)
    if lowered_bytes != first["stats"][0]["wire_bytes"]:
        fail(f"{tag}: the lowered programs' bytes {lowered_bytes} are not the ranks' "
             f"refresh-epoch wire_bytes {first['stats'][0]['wire_bytes']}")
    for k, v in lower_launches.items():
        if v <= 0:
            fail(f"{tag}: lowering the ranks' programs launched no {k} kernel")
    if not lowered.collective_order()["inter_a2a_before_compute"]:
        fail(f"{tag}: a rank posts the wire between groups after its local aggregation")
    losses = [m["loss"] for m in first["epochs"]]
    ref = [m["loss"] for m in stacked["epochs"]]
    diffs = [abs(a - b) for a, b in zip(losses, ref)]
    _print_sm_epochs(tag, first["epochs"], first["stats"], multi["losses"], "multiproc")
    print(f"[{tag}] against phase 7's stacked losses: diffs {[f'{x:.3e}' for x in diffs]}; "
          f"eval accuracy {first['acc']:.4f} (multiproc {multi['eval_acc']:.4f}, stacked "
          f"{stacked['eval_acc']:.4f})", flush=True)
    for r, total in enumerate(first["per_rank"]):
        print(f"[{tag}] rank {r} kernel launches (4 epochs + eval): {total}", flush=True)
    for r in smry["ranks"]:
        print(f"[{tag}] rank {r['rank']} at the end: device memory allocated "
              f"{r.get('device_bytes', 0) / 1e6:.1f} MB, peak "
              f"{r.get('device_peak_bytes', 0) / 1e6:.1f} MB; RSS {r['rss_now'] / 1e6:.1f} MB",
              flush=True)
    second = [m["loss"] for m in runs[1]["epochs"]]
    print(f"[{tag}] second run from the epoch-0 checkpoint: losses {second}, eval "
          f"{runs[1]['acc']:.4f}; leaked segments {leaked}", flush=True)
    if not all(math.isfinite(v) for v in losses):
        fail(f"{tag}: non-finite losses {losses}")
    if losses != multi["losses"]:
        fail(f"{tag}: losses {losses} are not bitwise phase 12's multiproc losses "
             f"{multi['losses']}")
    if diffs[0] > TOL or max(diffs[1:]) > 1e-3:
        fail(f"{tag}: losses differ from the stacked run's: {diffs} (bars {TOL} at "
             "epoch 0, 1e-3 after)")
    for r, total in enumerate(first["per_rank"]):
        for k, v in total.items():
            if v <= 0:
                fail(f"{tag}: rank {r} launched no {k} kernel")
    wb = [st["wire_bytes"][0] for st in first["stats"]]
    if not wb[1] < wb[0]:
        fail(f"{tag}: a stale epoch moved no fewer wire bytes than a refresh: {wb}")
    if second != losses or runs[1]["acc"] != first["acc"]:
        fail(f"{tag}: the second run differs: {second} vs {losses}")
    if leaked:
        fail(f"{tag}: leaked shared-memory segments {leaked}")
    cards = torch.cuda.device_count()
    nccl = [shard_map_nccl(dev, label, over, cache) for label, need, over in SM_NCCL
            if cards >= need]
    secs = time.perf_counter() - t_phase
    print(f"[shard_map] phase 19 in {secs:.1f} s ({cards} visible card(s): NCCL ran "
          f"{[label for label, need, _ in SM_NCCL if cards >= need]})", flush=True)
    launched = {k: sum(t[k] for t in first["per_rank"]) for k in first["per_rank"][0]}
    return {"losses": losses, "diffs": diffs, "stats": first["stats"],
            "launches": launched, "per_rank": first["per_rank"], "checked": checked,
            "lower_launches": lower_launches, "lower_s": lower_s, "nccl": nccl,
            "seconds": secs}


# -- phase 14: audit and tune -------------------------------------------------

TUNE_TOP_K = 3
AUTO_EPOCHS = 2
# The shard_map specs of specs/ and their ranks.
SHARD_MAP_SPECS = {"flagship_hier_int2_overlap.json": 8, "shard_map.json": 4}


def _stage_bytes(step, level) -> int:
    return sum(o.bytes for o in step.collectives("all-to-all") if o.level == level)


def _train_bitwise(spec, dev, cache):
    from repro_torch.run import build_session

    sess = build_session(spec, device=dev, cache=cache)
    losses = [sess.train_epoch()["loss"] for _ in range(AUTO_EPOCHS)]
    leaves = [v for p in sess.trainer.params["layers"] for v in p.values()]
    return sess.schedule, losses, leaves + [sess.trainer.params["lp_embed"]]


def _quantized(spec) -> bool:
    sched = spec.schedule.to_dist_config(spec.partition).schedule()
    return any(s.bits for s in sched.stages)


def check_session_kernels(session, dev, label: str, fs=(100, 256, 47)) -> dict:
    """Every kernel of one stacked session's path against its plain version,
    at the layouts and wire rows that session built (a tuned partition such
    as ``refine=bucket-max`` moves hub rows, so its buckets differ from
    phase 7's). seg_aggregate forward, and its backward through autograd
    over the reverse layout, on the local graph and on every stage's send
    gather, pre-aggregation and receive scatter; two launches bitwise on all of
    them; quant_pack and dequant_unpack at each quantized stage's wire rows
    (after the psum_scatter of a grouped stage), bitwise. F in ``fs``,
    rtol = atol = TOL; fails on any mismatch."""
    import numpy as np
    import torch

    from repro_torch.kernels import seg_aggregate as sa

    layouts = train_layouts(session)
    p = session.wd.x.shape[0]
    reverse = {name[:-2]: lay for name, lay, _, _, bwd in layouts if bwd}
    worst = {"seg_aggregate": 0.0, "seg_aggregate_backward": 0.0,
             "quant_pack": 0.0, "dequant_unpack": 0.0}
    for f in fs:
        for name, lay, n_in, n_out, bwd in layouts:
            if bwd:
                continue
            x = torch.randn((p, n_in, f), device=dev, requires_grad=True)
            y = sa.bucketed_aggregate(x, lay, n_out, ell_t=reverse[name])
            worst["seg_aggregate"] = max(worst["seg_aggregate"], max_err(
                y, sa.bucketed_forward_ref(x.detach(), lay, n_out)))
            g = torch.randn_like(y)
            (dx,) = torch.autograd.grad(y, x, g)
            worst["seg_aggregate_backward"] = max(worst["seg_aggregate_backward"], max_err(
                dx, sa.bucketed_forward_ref(g, reverse[name], n_in)))
    repeat = check_repeats(layouts, dev, verbose=False)
    worst["seg_aggregate"] = max(worst["seg_aggregate"], repeat)

    rng = np.random.default_rng(14)
    sched, shapes = session.schedule, []
    for stage in sched.stages:
        if not stage.bits:
            continue
        rows = sched.plan_for(stage, session.wd).send_gather_idx.shape[-1]
        topo = sched.topo(stage)
        if topo.kind != "a2a":
            rows //= topo.shard_size
        for f in fs:
            x = torch.from_numpy(rng.normal(size=(p * rows, f)).astype(np.float32)).to(dev)
            u = torch.from_numpy(rng.uniform(size=(p * rows, f)).astype(np.float32)).to(dev)
            for k, e in zip(("quant_pack", "dequant_unpack"),
                            compare_quant(x, u, stage.bits, f)):
                worst[k] = max(worst[k], e)
        shapes.append((stage.level, p * rows, stage.bits))
    print(f"[tune] kernels of {label}: seg_aggregate forward and backward on its "
          f"{len(layouts)} layouts ({', '.join(n for n, *_ in layouts)}) at F in "
          f"{tuple(fs)}, two launches bitwise, max abs err "
          f"{worst['seg_aggregate']:.3e} forward, {worst['seg_aggregate_backward']:.3e} "
          f"backward (rtol=atol={TOL}); quant_pack and dequant_unpack bitwise at "
          f"(stage, rows, bits) {shapes or 'none (no quantized stage)'}", flush=True)
    return worst


def audit_tune_phase(dev) -> dict:
    """Phase 14 on the card: the spec matrix, the audit gate over specs/ and
    the lint, the audit of train_products_paper with its recorded wire
    bytes beside the prediction, the audit-gated tuner with stacked probes,
    and exec.auto against the explicit winner, bitwise. The launch counts
    are reset just before and read just after."""
    import torch

    from repro_torch.analysis.audit import audit_paths
    from repro_torch.analysis.rules import STACKED_OVERRIDES, AuditContext, run_rules
    from repro_torch.configs.train_products_paper import train_products_paper
    from repro_torch.core.perf_model import get_hardware
    from repro_torch.run import BuildCache, RunSpec, build_session
    from repro_torch.run.matrix import _is_serve_path, run_matrix
    from repro_torch.run.tune import DEFAULT_AXES, tune

    reset_counts()
    t_phase = time.perf_counter()
    secs = {}

    t0 = time.perf_counter()
    recs = run_matrix(ROOT / "specs", device=dev, verbose=False)
    secs["matrix"] = time.perf_counter() - t0
    for r in recs:
        extra = {k: r[k] for k in ("ranks", "lowered_ops", "served") if k in r}
        if "store" in r:
            extra["store_bytes"] = r["store"]["store_bytes"]
        print(f"[matrix] {r['spec']:32s} {r.get('hash', '-'):16s} {r['status']} "
              f"{r['elapsed_s']} s {extra}" + (f" :: {r['error']}" if "error" in r else ""),
              flush=True)
    bad = [f"{r['spec']} ({r.get('hash', '-')}): {r.get('error')}" for r in recs
           if r["status"] != "ok"]
    ranked = {r["spec"]: r["ranks"] for r in recs if "ranks" in r}
    if bad or len(recs) != 8:
        fail(f"spec matrix on the card: {len(recs)} specs, errors {bad}")
    if ranked != SHARD_MAP_SPECS:
        fail(f"spec matrix: the shard_map specs must lower as their ranks' programs "
             f"{SHARD_MAP_SPECS}, got {ranked}")
    by = {r["spec"]: r for r in recs}
    if "store" not in by["multiproc_p4.json"] or by["serve_flagship.json"].get("served") != 4:
        fail("spec matrix: multiproc gave no dry plan or the serve spec served no burst")

    t0 = time.perf_counter()
    report = audit_paths(sorted((ROOT / "specs").glob("*.json")),
                         lint=[str(ROOT / "src" / "repro_torch")], verbose=False,
                         device=dev)
    secs["audit_specs"] = time.perf_counter() - t0
    for r in report["specs"]:
        print(f"[audit] {r['spec']:32s} {r.get('hash', '-'):16s} ran {len(r['ran'])} "
              f"skipped {len(r['skipped'])} findings {len(r['findings'])} "
              f"{'ranks ' + str(r['ranks']) if 'ranks' in r else ''} {r['elapsed_s']} s",
              flush=True)
    print(f"[audit] ast-lint src/repro_torch: {len(report['lint']['findings'])} findings",
          flush=True)
    if report["summary"]["findings"]:
        fail(f"audit of specs/ and the lint on the card: {report['summary']}")
    # The shard_map specs, on their ranks' programs: every rule that ran on
    # their stacked stand-in runs (shard_map.json ships fp32, so wire-dtype
    # does not apply).
    audited = {r["spec"]: r for r in report["specs"]}
    for name, ranks in SHARD_MAP_SPECS.items():
        r = audited[name]
        skipped = [] if name.startswith("flagship") else ["wire-dtype"]
        if r.get("ranks") != ranks or r["skipped"] != skipped or r["rule_errors"]:
            fail(f"audit of {name} on the card: ranks {r.get('ranks')}, ran {r['ran']}, "
                 f"skipped {r['skipped']} (want {ranks} ranks, skipped {skipped})")

    # Each shard_map spec's rank programs, lowered on the card: op counts,
    # collectives and seconds. Their kernels are held to the plain versions
    # at the ranks' shapes below, after the counts are read.
    for name in SHARD_MAP_SPECS:
        with build_session(RunSpec.load(ROOT / "specs" / name), device=dev) as sess:
            t0 = time.perf_counter()
            progs = sess.lower().programs
            torch.cuda.synchronize()
            secs[f"lower {name}"] = time.perf_counter() - t0
            by_kind = {}
            for o in progs[0].collectives():
                by_kind[o.kind] = by_kind.get(o.kind, 0) + 1
            print(f"[audit] {name}: {len(progs)} rank programs lowered on the card in "
                  f"{secs[f'lower {name}']:.3f} s; ops per rank "
                  f"{[len(p.ops) for p in progs]}; collectives per rank "
                  f"{[len(p.collectives()) for p in progs]} (rank 0 by kind {by_kind}); "
                  f"all-to-all bytes per rank "
                  f"{[sum(o.bytes for o in p.collectives('all-to-all')) for p in progs]}",
                  flush=True)

    t0 = time.perf_counter()
    base = train_products_paper()
    ctx = AuditContext(base, spec_name="train_products_paper", device=dev)
    try:
        res = run_rules(ctx)
        step, predicted = ctx.lowered, ctx.predicted_bytes
    finally:
        ctx.close()
    secs["audit_train_products_paper"] = time.perf_counter() - t0
    print(f"[audit] train_products_paper: ran {sorted(res['ran'])}, skipped "
          f"{res['skipped']}, findings {[str(f) for f in res['findings']]}", flush=True)
    if len(res["ran"]) != 5 or res["findings"]:
        fail("the audit of train_products_paper on the card is not clean with five "
             "rules run")
    for level in [s.level for s in ctx.schedule.stages] + ["total"]:
        got = (sum(o.bytes for o in step.collectives("all-to-all")) if level == "total"
               else _stage_bytes(step, level))
        print(f"[audit] all-to-all bytes per worker per step, {level}: recorded {got}, "
              f"predicted {predicted[level]:.0f}", flush=True)

    t0 = time.perf_counter()
    cache = BuildCache()
    result = tune(base, axes=DEFAULT_AXES, top_k=TUNE_TOP_K, probe_mode="vmap",
                  hw=get_hardware("measured"), cache=cache, device=dev)
    secs["tune"] = time.perf_counter() - t0
    for r in result["rows"]:
        print(f"[tune] row {r['spec_hash']} {' '.join(r['overrides']) or '(base)'}: "
              f"modelled {r['modelled_epoch_s'] * 1e3:.6f} ms", flush=True)
    for c in result["rejected"]:
        print(f"[tune] rejected {c['spec_hash']}: {c['audit']['findings']}", flush=True)
    for c in result["shortlist"]:
        p = c["probe"]
        print(f"[tune] shortlist {c['spec_hash']} {' '.join(c['overrides']) or '(base)'}: "
              f"measured {c['measured_epoch_s'] * 1e3:.3f} ms (period {p['period']}, "
              f"epochs {[round(t * 1e3, 3) for t in p['epochs_s']]} ms), modelled "
              f"{c['modelled_epoch_s'] * 1e3:.6f} ms, calibration {c['calibration']:.1f}",
              flush=True)
    w = result["winner"]
    if w is None or len(result["shortlist"]) != TUNE_TOP_K:
        fail(f"the tuner shortlisted {len(result['shortlist'])} of {TUNE_TOP_K}")
    print(f"[tune] winner {w['spec_hash']} {' '.join(w['overrides']) or '(base)'}; "
          f"calibration (median) {result['calibration']:.1f}; hw {result['hw']}", flush=True)
    out = ROOT / "build" / "tuned_products_paper.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))

    t0 = time.perf_counter()
    winner = RunSpec.from_dict(w["spec"])
    sa, la, pa = _train_bitwise(base.with_overrides([f"exec.auto={out}"]), dev, cache)
    sb, lb, pb = _train_bitwise(winner, dev, cache)
    same = la == lb and all(torch.equal(a, b) for a, b in zip(pa, pb))
    secs["exec_auto"] = time.perf_counter() - t0
    print(f"[tune] exec.auto={out.relative_to(ROOT)}: losses {la}, explicit winner "
          f"{lb}; bitwise (losses, parameters) {same}; schedule {sa.describe()}",
          flush=True)
    if not same or sa != sb:
        fail("exec.auto does not train bitwise as the explicit winner spec")

    launched = counts()
    uses_quant = any(_quantized(base.with_overrides(c["overrides"]))
                     for c in result["shortlist"])
    need = ["seg_aggregate", "seg_aggregate_backward"] + (
        ["quant_pack", "dequant_unpack"] if uses_quant else [])
    print(f"[tune] kernel launches in phase 14: "
          + ", ".join(f"{k} {v}" for k, v in launched.items()), flush=True)
    for k in need:
        if launched[k] <= 0:
            fail(f"phase 14 launched no {k} kernel")

    # After the counts are read: the kernels against their plain versions
    # on the layouts of every shortlisted candidate and of every training
    # spec in specs/ (the matrix's and the audit's flat and hierarchical
    # toy sessions; multiproc as its stacked variant), and for the
    # shard_map specs, whose rank programs were lowered, at the ranks'
    # shapes and on their stacked variants' layouts.
    t0 = time.perf_counter()
    worst = dict.fromkeys(("seg_aggregate", "seg_aggregate_backward", "quant_pack",
                           "dequant_unpack"), 0.0)
    sessions = [(f"candidate {c['spec_hash']} {' '.join(c['overrides']) or '(base)'}",
                 base.with_overrides(c["overrides"])) for c in result["shortlist"]]
    for path in sorted((ROOT / "specs").glob("*.json")):
        if not _is_serve_path(path):
            spec = RunSpec.load(path)
            if spec.exec.mode == "shard_map":
                sessions.append((f"specs/{path.name}", spec))
            if spec.exec.mode != "vmap":
                spec = spec.with_overrides(list(STACKED_OVERRIDES))
            sessions.append((f"specs/{path.name}" + (" stacked" if path.name in
                                                     SHARD_MAP_SPECS else ""), spec))
    for label, spec in sessions:
        sess = build_session(spec, device=dev, cache=cache)
        try:
            if spec.exec.mode == "shard_map":
                errs = check_rank_kernels(sess.trainer, dev, tag=f"tune {label} ranks",
                                          need_quant=_quantized(spec))["max_abs_err"]
            else:
                errs = check_session_kernels(sess, dev, label)
            for k, e in errs.items():
                worst[k] = max(worst[k], e)
        finally:
            sess.close()
    secs["kernel_checks"] = time.perf_counter() - t0

    secs["phase"] = time.perf_counter() - t_phase
    print(f"[tune] seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()),
          flush=True)
    return {"launches": launched, "max_abs_err": worst}


# -- phase 15: LM serving -------------------------------------------------------

# Card vs CPU and decode vs forward, × max|logit|: serve_llm.bf16_bar at
# bf16 (2e-2; more by family and depth where the reference's own distance
# is larger) and serve_llm.FP32_BAR (1e-5) at fp32, the reasons beside
# them there.
LM_BATCH, LM_PROMPT, LM_GEN = 4, 12, 24
# (architecture, layers kept): deepseek's 27 layers are 64.8 GB in fp32,
# which does not fit beside their bf16 copy and the work buffers; the
# others run at full depth.
LM_CONFIGS = (("tinyllama-1.1b", None), ("granite-moe-1b-a400m", None),
              ("deepseek-v2-lite-16b", 4), ("zamba2-2.7b", None), ("xlstm-350m", None),
              ("whisper-small", None))


def lm_step_bytes(served, cfg, batch: int, experts_read: float,
                  tokens_read: float) -> float:
    """Bytes one decode step must move: every compute-dtype weight it uses
    once (the embedding's ``batch`` rows unless it is the tied head; the
    routed experts only as many as the step selects, ``experts_read``
    summed over layers; zamba2's shared block once; not whisper's encoder,
    which runs once a request), ``tokens_read`` cached tokens of each K/V
    or latent cache (zamba2's: one a shared-block application), whisper's
    cross K/V whole, and every recurrent state and conv state read and
    written."""
    from repro_torch.models.transformer import init_cache
    from repro_torch.utils.trees import tree_bytes

    blocks = served["blocks"]
    experts = {k: blocks["moe"][k] for k in ("w_gate", "w_up", "w_down")} if cfg.moe else {}
    rest = {k: v for k, v in served.items()
            if k not in ("embed", "blocks", "enc_blocks", "enc_pos", "enc_norm")}
    total = tree_bytes(rest) + tree_bytes(blocks) - tree_bytes(experts)
    emb = served["embed"]
    total += tree_bytes(emb) if cfg.tie_embeddings else batch * emb[0].numel() * emb.element_size()
    if cfg.moe:
        total += experts_read * tree_bytes(experts) / (cfg.num_layers * cfg.moe.num_experts)
    one = init_cache(cfg, batch, 1, device="meta")      # one cached token a layer

    def per_token(c) -> int:
        return tree_bytes(c._replace(pos=None))

    if cfg.family == "hybrid":
        return total + 2 * tree_bytes(one.layers) + tokens_read * per_token(one.extra)
    if cfg.family == "ssm":
        return total + 2 * tree_bytes(one.layers)
    return total + tokens_read * per_token(one.layers) + tree_bytes(one.extra)


def lm_reduced_cfg(cfg):
    """``cfg`` at full width with the first layers only: 2 (whisper: 2 +
    2), zamba2 ``attn_every`` (so the shared block runs once), xLSTM one
    group."""
    import dataclasses

    n = {"hybrid": cfg.attn_every, "ssm": cfg.xlstm_group}.get(cfg.family, 2)
    return dataclasses.replace(cfg, num_layers=n, enc_layers=min(cfg.enc_layers, 2))


def lm_reduced(cfg, served):
    """The config and weights of the card-vs-CPU check (``lm_reduced_cfg``:
    full width, the first layers only)."""
    from repro_torch.utils.trees import tree_map

    small = lm_reduced_cfg(cfg)
    n = small.num_layers
    stacked = n // cfg.xlstm_group if cfg.family == "ssm" else n
    weights = {**served, "blocks": tree_map(lambda a: a[:stacked], served["blocks"])}
    if cfg.family == "audio":
        weights["enc_blocks"] = tree_map(lambda a: a[:2], served["enc_blocks"])
    return small, weights


def lm_compare(label: str, got, want, got_routes, want_routes, cfg, bar: float) -> dict:
    """Logits [B, S, V] of two runs within ``bar`` x max|logit|. A token
    whose experts differ between the runs in some layer (a near-tie that
    bf16 rounding flips) is counted and printed, and it and the later
    positions of its sequence that attend to it are left out of the bar;
    a flip that is no near-tie fails."""
    import torch

    from repro_torch.launch.serve_llm import router_flips

    b, s, _ = want.shape
    flipped, affected, not_ties = router_flips(got_routes, want_routes, cfg, b, s)
    if not_ties:
        fail(f"{label}: experts differ without a near-tie (layer, b, s, want's only, "
             f"got's only): {not_ties[:5]}")
    got, want = got.float().cpu(), want.float().cpu()
    ref = float(want.abs().max())
    per_token = (got - want).abs().amax(-1) / ref                    # [B, S]
    keep = torch.ones((b, s), dtype=torch.bool)
    for i, j in affected:
        keep[i, j] = False
    err = float(per_token[keep].max()) * ref if bool(keep.any()) else 0.0
    worst = divmod(int(per_token.argmax()), s)
    print(f"{label}: max |diff| {err:.6g} = {err / ref:.4e} of max|logit| {ref:.6g} "
          f"(bar {bar}); router flips (near-ties): {len(flipped)} tokens "
          f"{sorted(flipped)[:8]}, left out with the later positions of their "
          f"sequences: {len(affected)} of {b * s}; worst token {worst} at "
          f"{float(per_token.max()):.4e}", flush=True)
    if not err <= bar * ref:
        fail(f"{label}: logits differ by {err} > {bar} x {ref}")
    return {"rel_err": err / ref, "flipped": len(flipped), "left_out": len(affected)}


def lm_config_phase(name: str, layers, dev, smi: str) -> dict:
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve_llm import (FP32_BAR, RecordRoutes, bf16_bar, build_lm,
                                              draw_frames, full_forward, generate,
                                              teacher_forced)
    from repro_torch.models.moe import _capacity
    from repro_torch.utils.trees import tree_bytes, tree_map

    full = get_arch(name)
    cfg = full if layers is None else dataclasses.replace(full, num_layers=layers)
    tag = f"[lm] {name}"
    cut = ("all" if layers is None else
           f"the first {layers} of {full.num_layers} (all {full.num_layers} in fp32: "
           f"{full.param_count() * 4 / 1e9:.1f} GB)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)     # what earlier phases still hold
    t0 = time.perf_counter()
    lm = build_lm(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = cfg.param_count()
    print(f"{tag}: full width (d={cfg.d_model}, {cfg.num_heads}H, kv {cfg.num_kv_heads}, "
          f"vocab {cfg.vocab_size}), layers: {cut}; {n_params:,} parameters, "
          f"fp32 {tree_bytes(lm.params) / 1e9:.3f} GB + bf16 copy "
          f"{tree_bytes(lm.served) / 1e9:.3f} GB, built in {build_s:.2f} s", flush=True)
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=torch.Generator().manual_seed(0))
    # Whisper's frame embeddings, from seed 0; encoded in each run's prefill.
    frames = draw_frames(cfg, LM_BATCH, 0) if cfg.family == "audio" else None

    # The default mix twice: the first run records the routing (for the
    # bound and the checks below) and is the reference of the second,
    # which is timed.
    with RecordRoutes() as routes:
        first = generate(lm, prompts, LM_GEN, frames)
    second = generate(lm, prompts, LM_GEN, frames)
    peak = torch.cuda.max_memory_allocated(dev) - held
    for run in (first, second):
        if not bool(torch.isfinite(run.logits).all()):
            fail(f"{name}: non-finite logits")
    if not (torch.equal(first.tokens, second.tokens)
            and torch.equal(first.logits, second.logits)):
        fail(f"{name}: a second run of the same prompts is not bitwise equal")
    steps = second.decode_steps
    decode_ms = second.decode_s / steps * 1e3
    tok_s = LM_BATCH * steps / second.decode_s
    experts_read = 0.0
    prefill_calls = LM_PROMPT * cfg.num_layers if cfg.moe else 0
    if cfg.moe:
        decode_calls = routes.calls[prefill_calls:]
        experts_read = sum(int(torch.unique(s).numel()) for _, s in decode_calls) / steps
    tokens_read = LM_PROMPT + LM_GEN / 2                     # mean of pos + 1
    step_bytes = lm_step_bytes(lm.served, cfg, LM_BATCH, experts_read, tokens_read)
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    print(f"{tag}: batch {LM_BATCH}, prompt {LM_PROMPT}, gen {LM_GEN} (second run): "
          f"prefill {second.prefill_s:.4f} s, decode {decode_ms:.4f} ms/step "
          f"(CUDA-synchronized host clock, {steps} steps), {tok_s:.1f} tok/s, peak device "
          f"memory {peak / 1e9:.3f} GB (above the {held / 1e9:.3f} GB earlier phases hold); "
          f"decode bound {bound_ms:.4f} ms/step "
          f"({step_bytes / 1e9:.4f} GB a step over 3.35 TB/s"
          + (f", {experts_read / cfg.num_layers:.2f} of {cfg.moe.num_experts} experts "
             f"a layer" if cfg.moe else "")
          + f", K/V caches {tokens_read:.0f} tokens a layer); {smi}", flush=True)
    print(f"{tag}: logits finite; second run bitwise equal (tokens, "
          f"{tuple(second.logits.shape)} logits); req 0: {second.tokens[0, :12].tolist()}",
          flush=True)
    prefill = RecordRoutes()
    prefill.calls = routes.calls[:prefill_calls]
    # Where a step's time goes: 5 serve_steps (1 prefill, 4 decode) profiled
    # (whisper's against a zero cross cache: the same work, no encoder).
    wall, busy, by_name = profile_device(lambda: generate(lm, prompts[:, :1], 5))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    print(f"{tag}: profiled 5 serve_steps: wall {wall * 1e3:.3f} ms (profiler on), device "
          f"busy {busy * 1e3:.3f} ms ({1 - busy / wall:.2%} idle); top: "
          + "; ".join(f"{k[:60]} {v * 1e3:.3f} ms" for k, v in top), flush=True)

    # Card vs CPU: the first layers at full width (lm_reduced), the same
    # weights, teacher-forced.
    small, card_w = lm_reduced(cfg, lm.served)
    depth = (f"{small.num_layers} + {small.enc_layers} layers" if cfg.family == "audio"
             else f"{small.num_layers} layers")
    t0 = time.perf_counter()
    with RecordRoutes() as card_r:
        card = teacher_forced(card_w, small, prompts.to(dev), frames)
    with RecordRoutes() as host_r:
        host = teacher_forced(tree_map(lambda t: t.cpu(), card_w), small, prompts, frames)
    parity = lm_compare(f"{tag}: card vs CPU, {depth}, {LM_PROMPT} teacher-forced tokens "
                        f"({time.perf_counter() - t0:.2f} s)", card, host, card_r, host_r,
                        small, bf16_bar(small))

    # Decode vs the full forward on the card, every prompt position. Decode
    # never drops an expert assignment (capacity >= batch); the forward's
    # capacity is raised so it drops none either, and its shipped capacity
    # is reported beside it.
    fcfg = cfg
    if cfg.moe:
        if _capacity(LM_BATCH, cfg.moe) < LM_BATCH:
            fail(f"{name}: decode at batch {LM_BATCH} could drop expert assignments")
        fcfg = dataclasses.replace(
            cfg, moe=cfg.moe._replace(capacity_factor=float(cfg.moe.num_experts)))
    with RecordRoutes() as fwd_r:
        fwd = full_forward(lm.served, fcfg, prompts.to(dev), frames)
    decode = lm_compare(f"{tag}: decode vs forward_train on the card, {LM_PROMPT} "
                        f"positions x {LM_BATCH}", first.logits[:, :LM_PROMPT], fwd,
                        prefill, fwd_r, cfg, bf16_bar(cfg))
    # The same at fp32 (the fp32 parameters, COMPUTE_DTYPE float32 for this
    # check only), where rounding is far too small to flip all but the
    # closest ties: it holds the tokens that bf16 flips leave out.
    from repro_torch.models import common
    common.COMPUTE_DTYPE = torch.float32
    try:
        with RecordRoutes() as dec32_r:
            dec32 = teacher_forced(lm.params, cfg, prompts.to(dev), frames)
        with RecordRoutes() as fwd32_r:
            fwd32 = full_forward(lm.params, fcfg, prompts.to(dev), frames)
    finally:
        common.COMPUTE_DTYPE = torch.bfloat16
    decode32 = lm_compare(f"{tag}: fp32 decode vs forward_train on the card", dec32, fwd32,
                          dec32_r, fwd32_r, cfg, FP32_BAR)
    if cfg.moe:
        with RecordRoutes() as shipped:
            full_forward(lm.served, cfg, prompts.to(dev))
        cap = _capacity(LM_BATCH * LM_PROMPT, cfg.moe)
        dropped = sum(int((torch.bincount(s.flatten(), minlength=cfg.moe.num_experts)
                           - cap).clamp(min=0).sum()) for _, s in shipped.calls)
        print(f"{tag}: at its shipped capacity ({cap} a layer and expert) the forward "
              f"drops {dropped} of {cfg.num_layers * LM_BATCH * LM_PROMPT * cfg.moe.top_k} "
              f"expert assignments (decode drops none), hence the raised capacity above",
              flush=True)
    out = {"arch": name, "layers": cfg.num_layers, "of_layers": full.num_layers,
           "params": n_params, "prefill_s": second.prefill_s, "decode_ms": decode_ms,
           "tok_s": tok_s, "peak_gb": peak / 1e9, "bound_ms": bound_ms,
           "step_gb": step_bytes / 1e9, "profiled_busy_share": busy / wall,
           "card_vs_cpu": parity, "decode_vs_forward": decode, "fp32_decode_vs_forward": decode32}
    del lm, first, second, card, host, fwd, dec32, fwd32
    torch.cuda.empty_cache()
    return out


def lm_phase(dev, smi: str) -> list:
    """Phase 15 on the card: LM serving through the port's entry point,
    for each of LM_CONFIGS."""
    t0 = time.perf_counter()
    out = [lm_config_phase(name, layers, dev, smi) for name, layers in LM_CONFIGS]
    for r in out:
        print(f"[lm] {json.dumps(r)}", flush=True)
    print(f"[lm] phase 15 in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# -- phase 16: LM training ------------------------------------------------------

# The main path at full width and depth, at configs/shapes train_4k's 4096
# tokens a sequence. Batch 8: train_4k's global batch of 256, cut to one
# card; 4 micro-batches of 2 sequences, 8192 tokens each (the reference's
# MB_TOKENS_PER_DEVICE, src/repro/launch/input_specs.py).
LM_TRAIN_ARCHS = ("tinyllama-1.1b", "granite-moe-1b-a400m")
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_MB, LM_TRAIN_STEPS = 8, 4096, 4, 5
BF16_FLOP_PER_S = 989e12     # H100 SXM dense bf16 (data sheet)
# Card vs CPU at fp32: the loss relative, each gradient, mu and nu leaf
# × its tree's max; the GNN trainer's bar (cuBLAS sums the products in
# another order than the CPU's BLAS).
LM_TRAIN_FP32_BAR = 1e-5
# Card vs CPU, one train_step at num_microbatches=2 over 2 sequences of
# this many tokens, each configuration at full width with its first
# layer (lm_parity_cfg). zamba2 at 256 tokens: two of its 128-token SSD
# chunks, the length where the reference's decay overflows (C-ref14).
# qwen2-vl's sequences start with 64 patches (its 256 cut to keep the
# CPU's side short; the count changes no code path).
LM_TRAIN_REDUCED = (("tinyllama-1.1b", 128), ("granite-moe-1b-a400m", 128),
                    ("deepseek-v2-lite-16b", 128), ("qwen2-vl-2b", 128),
                    ("zamba2-2.7b", 256), ("xlstm-350m", 128), ("whisper-small", 128))
LM_TRAIN_PATCHES = 64


def lm_model_flops(cfg, tokens: int, seq: int) -> float:
    """Model FLOPs of one training step over ``tokens`` tokens in sequences
    of ``seq``: 6 x N x tokens, N the parameters of the products a token
    passes through (all but the embedding gather; of the routed experts
    only top_k of num_experts), plus PaLM's attention count, 12 x layers x
    heads x head_dim x seq a token (both attention products over the whole
    sequence, forward and backward). Recompute is not counted."""
    from repro_torch.models.transformer import init_params
    from repro_torch.utils.trees import param_count

    meta = init_params(None, cfg, "meta")
    n = param_count(meta) - (0 if cfg.tie_embeddings else meta["embed"].numel())
    if cfg.moe:
        experts = sum(meta["blocks"]["moe"][k].numel() for k in ("w_gate", "w_up", "w_down"))
        n -= experts * (1 - cfg.moe.top_k / cfg.moe.num_experts)
    return 6 * n * tokens + 12 * cfg.num_layers * cfg.num_heads * cfg.hd * seq * tokens


def lm_train_run(cfg, batches, dev, profile: bool = False):
    """LM_TRAIN_STEPS ``train_step``s from seed-0 parameters on ``dev``:
    (losses, step seconds on the CUDA-synchronized host clock, params,
    optimizer state, and with ``profile`` the last step's
    ``profile_device`` reading)."""
    import torch

    from repro_torch.models import init_params, train_step
    from repro_torch.optim import adamw_init

    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    opt = adamw_init(params)
    losses, secs, profiled = [], [], None
    for i, batch in enumerate(batches):
        def step():
            return train_step(params, opt, batch, cfg, num_microbatches=LM_TRAIN_MB)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if profile and i == len(batches) - 1:
            out = []
            profiled = profile_device(lambda: out.append(step()))
            params, opt, loss = out[0]
        else:
            params, opt, loss = step()
        losses.append(float(loss))          # waits for the device
        secs.append(time.perf_counter() - t0)
    return losses, secs, params, opt, profiled


def lm_train_config(name: str, dev, smi: str) -> dict:
    """Phase 16 (a) and (b): ``name`` at full width and depth, trained
    twice from the same seed on TokenPipeline batches."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.serve_llm import RecordRoutes
    from repro_torch.models import forward_train
    from repro_torch.models.moe import _capacity
    from repro_torch.utils.trees import tree_leaves

    cfg = get_arch(name)
    tag = f"[lm-train] {name}"
    b, s = LM_TRAIN_BATCH, LM_TRAIN_SEQ
    tokens = b * s
    t0 = time.perf_counter()
    pipe = TokenPipeline(cfg.vocab_size, seed=0)
    batches = [{"tokens": torch.from_numpy(pipe.batch(b, s)).to(dev)}
               for _ in range(LM_TRAIN_STEPS)]
    drawn_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)     # what earlier phases still hold
    # The first run's last step is profiled (its values are compared, its
    # times are not reported); the second run is timed.
    losses, secs1, params1, opt1, (wall, busy, by_name) = lm_train_run(cfg, batches, dev,
                                                                      profile=True)
    peak = torch.cuda.max_memory_allocated(dev) - held
    again, secs, params, opt, _ = lm_train_run(cfg, batches, dev)
    if not all(map(math.isfinite, losses + again)):
        fail(f"{name}: a training loss is not finite: {losses}, {again}")
    if not losses[-1] < losses[0]:
        fail(f"{name}: the loss did not fall over {LM_TRAIN_STEPS} steps: {losses}")
    same = (losses == again and opt.step == opt1.step and all(
        torch.equal(x, y) for x, y in zip(tree_leaves((params, opt.mu, opt.nu)),
                                          tree_leaves((params1, opt1.mu, opt1.nu)))))
    if not same:
        fail(f"{name}: a second run from the same seed and batches is not bitwise "
             f"equal: losses {losses} vs {again}")
    del params1, opt1
    step_s = statistics.median(secs)
    flops = lm_model_flops(cfg, tokens, s)
    n_params = cfg.param_count()
    print(f"{tag}: full width and depth ({cfg.num_layers} layers, d={cfg.d_model}, "
          f"{cfg.num_heads}H, kv {cfg.num_kv_heads}, vocab {cfg.vocab_size}; {n_params:,} "
          f"parameters), batch {b} x {s} tokens in {LM_TRAIN_MB} micro-batches of "
          f"{tokens // LM_TRAIN_MB} tokens, bf16 compute, fp32 parameters and AdamW "
          f"(batches drawn in {drawn_s:.2f} s); losses {[round(x, 6) for x in losses]}; "
          f"second run bitwise equal (losses, parameters, AdamW state); first run step ms "
          f"{[round(x * 1e3, 3) for x in secs1]} (the last profiled)", flush=True)
    print(f"{tag}: second run, step ms {[round(x * 1e3, 3) for x in secs]} "
          f"(CUDA-synchronized host clock), median {step_s * 1e3:.3f} ms, "
          f"{tokens / step_s:.1f} tokens/s; model FLOPs {flops:.4e} a step "
          f"(6 x N x tokens + 12 x L x H x hd x S x tokens), "
          f"{flops / step_s / BF16_FLOP_PER_S:.2%} of 989 TFLOP/s bf16; peak device "
          f"memory {peak / 1e9:.3f} GB (above the {held / 1e9:.3f} GB earlier phases "
          f"hold); {smi}", flush=True)
    out = {"arch": name, "params": n_params, "losses": losses, "step_ms": [x * 1e3 for x in secs],
           "step_ms_median": step_s * 1e3, "tokens_s": tokens / step_s,
           "model_flops": flops, "mfu_bf16": flops / step_s / BF16_FLOP_PER_S,
           "peak_gb": peak / 1e9}
    if cfg.moe:
        first = batches[0]["tokens"][: b // LM_TRAIN_MB]
        with torch.no_grad(), RecordRoutes() as shipped:
            forward_train(params, cfg, first)
        cap = _capacity(first.numel(), cfg.moe)
        dropped = sum(int((torch.bincount(sel.flatten(), minlength=cfg.moe.num_experts)
                           - cap).clamp(min=0).sum()) for _, sel in shipped.calls)
        total = cfg.num_layers * first.numel() * cfg.moe.top_k
        print(f"{tag}: the forward of one micro-batch ({first.numel()} tokens) at the "
              f"shipped capacity ({cap} a layer and expert) drops {dropped} of {total} "
              f"expert assignments ({dropped / total:.2%}), after {LM_TRAIN_STEPS} steps",
              flush=True)
        out["dropped"], out["assignments"] = dropped, total
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"{tag}: one profiled step (the first run's last): wall {wall * 1e3:.3f} ms "
          f"(profiler on), device busy {busy * 1e3:.3f} ms ({busy / wall:.2%} busy); top: "
          + "; ".join(f"{k[:90]} {v * 1e3:.3f} ms" for k, v in top), flush=True)
    out["profiled_busy_share"] = busy / wall
    del params, opt, batches
    torch.cuda.empty_cache()
    return out


def lm_parity_cfg(cfg):
    """Phase 16's card-vs-CPU configuration: ``cfg`` at full width with its
    first layer only (whisper 1 + 1), where a family's smallest whole unit
    is one layer; zamba2 keeps ``attn_every`` layers (so the shared block
    runs once) and xLSTM one group (its sLSTM block)."""
    import dataclasses

    n = {"hybrid": cfg.attn_every, "ssm": cfg.xlstm_group}.get(cfg.family, 1)
    return dataclasses.replace(cfg, num_layers=n, enc_layers=min(cfg.enc_layers, 1))


def lm_train_parity(name: str, seq: int, dev) -> dict:
    """Phase 16 (c): one ``train_step`` at num_microbatches=2 (its two
    halves, ``loss_and_grads`` and ``adamw_update`` at lr 3e-4 with the
    clip at 1.0) on the card and on the CPU, from the same parameters and
    batch: at fp32 the loss, every gradient leaf and AdamW's mu and nu; at
    bf16 finite gradients on the card and its loss against the CPU's
    forward. Each part's seconds are printed (the CPU's take most)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve_llm import bf16_bar
    from repro_torch.launch.train import lm_batch
    from repro_torch.models import common, compute_loss, init_params, loss_and_grads
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.utils.trees import tree_leaves, tree_map

    cfg = dataclasses.replace(lm_parity_cfg(get_arch(name)), vision_patches=LM_TRAIN_PATCHES)
    tag = f"[lm-train] {name}: card vs CPU, " + (
        f"{cfg.num_layers} + {cfg.enc_layers} layers" if cfg.family == "audio"
        else f"{cfg.num_layers} layers") + f", 2 x {seq} tokens"
    card = (init_params(torch.Generator(device=dev).manual_seed(0), cfg),
            lm_batch(cfg, 2, seq, torch.Generator(device=dev).manual_seed(1)))
    host = tuple(tree_map(lambda t: t.cpu(), x) for x in card)

    def grads(dtype, params, batch):
        common.COMPUTE_DTYPE = dtype
        try:
            loss, g = loss_and_grads(params, cfg, batch, num_microbatches=2)
        finally:
            common.COMPUTE_DTYPE = torch.bfloat16
        if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(g)):
            fail(f"{tag}: a gradient is not finite at {dtype}")
        return float(loss), g

    def worst(got, want) -> float:
        """Max |got - want| over the leaves, over the max |want|."""
        pairs = list(zip(tree_leaves(got), tree_leaves(want)))
        scale = max(float(w.abs().max()) for _, w in pairs)
        return max(float((g.cpu() - w).abs().max()) for g, w in pairs) / scale

    secs = {}

    def timed(what, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        secs[what] = time.perf_counter() - t
        return out

    t0 = time.perf_counter()
    lc, gc = timed("card fp32", grads, torch.float32, *card)
    _, oc = timed("card adamw", lambda: adamw_update(gc, adamw_init(card[0]), card[0], 3e-4,
                                                      grad_clip=1.0))
    lh, gh = timed("cpu fp32", grads, torch.float32, *host)
    _, oh = timed("cpu adamw", lambda: adamw_update(gh, adamw_init(host[0]), host[0], 3e-4,
                                                     grad_clip=1.0))
    out = timed("compare", lambda: {
        "fp32_loss_rel": abs(lc - lh) / abs(lh), "fp32_grads": worst(gc, gh),
        "fp32_mu": worst(oc.mu, oh.mu), "fp32_nu": worst(oc.nu, oh.nu)})
    if not all(v <= LM_TRAIN_FP32_BAR for v in out.values()):
        fail(f"{tag}: fp32 loss {lc} vs {lh}; relative errors {out} (bar {LM_TRAIN_FP32_BAR})")
    del gc, gh, oc, oh
    # bf16: the card's gradients must be finite; its loss against the
    # CPU's forward alone, over the same two micro-batches of one row.
    lc, _ = timed("card bf16", grads, torch.bfloat16, *card)

    def host_loss():
        with torch.no_grad():
            return sum(compute_loss(host[0], cfg, {k: v[i:i + 1] for k, v in host[1].items()})
                       / 2 for i in range(2))

    lh = float(timed("cpu bf16 loss", host_loss))
    out["bf16_loss_rel"] = abs(lc - lh) / abs(lh)
    if not out["bf16_loss_rel"] <= bf16_bar(cfg):
        fail(f"{tag}: bf16 loss {lc} vs {lh}: {out['bf16_loss_rel']} > {bf16_bar(cfg)}")
    print(f"{tag} ({time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
          + f"): fp32 loss {out['fp32_loss_rel']:.3e} relative, worst gradient leaf {out['fp32_grads']:.3e}, mu {out['fp32_mu']:.3e}, "
          f"nu {out['fp32_nu']:.3e} of the tree's max (bar {LM_TRAIN_FP32_BAR}); bf16 loss "
          f"{out['bf16_loss_rel']:.3e} relative (bar {bf16_bar(cfg)}); every gradient "
          f"finite", flush=True)
    return {"arch": name, "layers": cfg.num_layers, "seq": seq, **out}


def lm_train_phase(dev, smi: str) -> dict:
    """Phase 16 on the card: LM training at full width and depth (the
    kernel launch counts reset just before and read just after), then
    card vs CPU for each family. The card's arithmetic is the launchers'
    (``resolve_device``: no TF32, no bf16 reduction of split-K partial
    sums), whether or not phase 15 ran first."""
    from repro_torch.launch.serve_llm import resolve_device

    resolve_device(dev)
    t0 = time.perf_counter()
    reset_counts()
    trained = [lm_train_config(name, dev, smi) for name in LM_TRAIN_ARCHS]
    launches = counts()
    print(f"[lm-train] kernel launches on the LM training path: {launches}", flush=True)
    t1 = time.perf_counter()
    parity = [lm_train_parity(name, seq, dev) for name, seq in LM_TRAIN_REDUCED]
    for r in trained + parity:
        print(f"[lm-train] {json.dumps(r)}", flush=True)
    print(f"[lm-train] phase 16 in {time.perf_counter() - t0:.1f} s (card vs CPU "
          f"{time.perf_counter() - t1:.1f} s)", flush=True)
    return {"launches": launches, "trained": trained, "parity": parity}


# -- phase 17: the GCN dry-run ----------------------------------------------------

# The JAX package's `make check-overlap` line (Makefile), then its default:
# every worker of the 16x16 production mesh, stacked on the card, at rmat-13.
DRYRUN_CHECK = ["--groups", "2", "--scale", "10", "--chips", "8", "--overlap",
                "--assert-overlap"]
DRYRUN_FULL = ["--chips", "256"]


def run_dryrun(args, dev, out: Path) -> dict:
    """One ``python -m repro_torch.launch.dryrun --gcn ARGS`` on the card,
    through its ``main``; its record, read back from ``out``. Fails unless
    the command exits 0 with status ok."""
    from repro_torch.launch import dryrun

    argv = ["--gcn", *args, "--device", str(dev), "--out", str(out)]
    t0 = time.perf_counter()
    try:
        dryrun.main(argv)
        code = 0
    except SystemExit as e:
        code = e.code
    secs = time.perf_counter() - t0
    recs = sorted(out.glob("*.json"))
    if code != 0 or len(recs) != 1:
        fail(f"dryrun {' '.join(argv)}: exit {code}, {len(recs)} records")
    rec = json.loads(recs[0].read_text())
    if rec["status"] != "ok":
        fail(f"dryrun {' '.join(argv)}: {rec.get('error')}")
    if dev.type == "cuda" and not (rec["memory"] or 0) > 0:
        fail(f"dryrun {' '.join(argv)}: no peak device memory recorded ({rec['memory']})")
    a2a = rec["collectives"]["all-to-all"]["result_bytes"]
    per_rank = set(rec["all_to_all_bytes_per_rank"])
    if rec.get("ranks") != rec["chips"] or "unrecorded" in rec["collectives"]:
        fail(f"dryrun {' '.join(argv)}: {rec.get('ranks')} rank programs of "
             f"{rec['chips']} workers, collectives {rec['collectives']}")
    if per_rank != {rec["predicted_hlo_wire_bytes"]["total"]} or a2a not in per_rank:
        fail(f"dryrun {' '.join(argv)}: recorded all-to-all bytes per rank {per_rank}, "
             f"predicted {rec['predicted_hlo_wire_bytes']}")
    rec["seconds"] = secs
    order = rec["collective_order"]
    print(f"[dryrun] {' '.join(args)}: {rec['shape']} on {rec['mesh']} "
          f"({rec['ranks']} rank programs) in {secs:.2f} s (the ranks' steps recorded "
          f"and counted in {rec['lower_s']} s); peak "
          f"{(rec['memory'] or 0) / 1e9:.3f} GB above what was held before it; "
          f"all-to-all bytes {a2a:.0f} per worker on every rank = predicted; "
          f"wire_before_compute {order['wire_before_compute']} inter_wire_before_compute "
          f"{order['inter_wire_before_compute']} inter_a2a_before_compute "
          f"{order['inter_a2a_before_compute']} on every rank; {order['num_events']} events "
          f"of rank 0's program", flush=True)
    print(f"[dryrun]   collectives {json.dumps(rec['collectives'])}", flush=True)
    print(f"[dryrun]   cost {json.dumps(rec['cost'])}; memory {rec['memory']}; "
          f"predicted wire bytes {json.dumps(rec['predicted_wire_bytes'])}; "
          f"audit findings {rec.get('audit_findings')}", flush=True)
    return rec


def dryrun_phase(dev, full=DRYRUN_FULL) -> dict:
    """Phase 17 on the card: the port's dry-run entry point on the check-
    overlap line, with --overlap and --no-overlap, then ``full`` (the JAX
    package's default: 256 workers at rmat-13). The kernel launch counts
    are reset just before the first run and read just after the last."""
    import shutil

    import torch

    from repro_torch.analysis.rules import STACKED_OVERRIDES
    from repro_torch.run import RunSpec, build_session

    t0 = time.perf_counter()
    base = ROOT / "build" / "dryrun_torch"
    shutil.rmtree(base, ignore_errors=True)
    held = torch.cuda.memory_allocated()
    reset_counts()
    check = run_dryrun(DRYRUN_CHECK, dev, base / "check_overlap")
    flags = ("wire_before_compute", "inter_wire_before_compute", "inter_a2a_before_compute")
    if not all(check["collective_order"][k] for k in flags):
        fail(f"dryrun with --overlap: {[check['collective_order'][k] for k in flags]}")
    no_overlap = [a for a in DRYRUN_CHECK if a not in ("--overlap", "--assert-overlap")]
    seq = run_dryrun(no_overlap + ["--no-overlap"], dev, base / "no_overlap")
    if any(seq["collective_order"][k] for k in flags):
        fail(f"dryrun with --no-overlap: {[seq['collective_order'][k] for k in flags]}")
    default = run_dryrun(full, dev, base / "default")
    launched = counts()
    print(f"[dryrun] kernel launches on the dry-run path (3 runs): "
          + ", ".join(f"{k} {v}" for k, v in launched.items()), flush=True)
    for k, v in launched.items():
        if v <= 0:
            fail(f"the dry-run path launched no {k} kernel")

    # After the counts are read: the check line on the CPU, whose cost and
    # collectives must be the card's (kernel calls count as one op on both
    # devices), then every kernel against its plain version: at the shapes
    # each run's ranks gave it, every rank, at the model's widths (128 in,
    # 256 hidden); and on each run's stacked layouts (all its workers in
    # one launch), at F in (100, 256, 47, 128).
    host = run_dryrun(DRYRUN_CHECK, torch.device("cpu"), base / "check_overlap_cpu")
    for key in ("cost", "collectives"):
        if host[key] != check[key]:
            fail(f"dryrun check line: {key} on the card {check[key]}, on the CPU {host[key]}")
    print(f"[dryrun] check line on the CPU in {host['seconds']:.2f} s: cost and "
          f"collectives equal the card's", flush=True)
    t1 = time.perf_counter()
    worst = dict.fromkeys(("seg_aggregate", "seg_aggregate_backward", "quant_pack",
                           "dequant_unpack"), 0.0)
    for rec in (check, seq, default):
        label = f"dryrun {rec['shape']} {rec['mesh']}"
        spec = RunSpec.from_dict(rec["spec"])
        sess = build_session(spec, device=dev)
        try:
            errs = check_rank_kernels(sess.trainer, dev, tag=label)["max_abs_err"]
        finally:
            sess.close()
        sess = build_session(spec.with_overrides(list(STACKED_OVERRIDES)), device=dev)
        try:
            stacked = check_session_kernels(sess, dev, f"{label} stacked",
                                            fs=(100, 256, 47, 128))
        finally:
            sess.close()
        for k in worst:
            worst[k] = max(worst[k], errs[k], stacked[k])
    print(f"[dryrun] kernels against their plain versions at the 3 runs' rank shapes "
          f"(every rank) and stacked layouts in {time.perf_counter() - t1:.2f} s: max "
          f"abs err " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()), flush=True)
    secs = time.perf_counter() - t0
    print(f"[dryrun] phase 17 in {secs:.1f} s; device memory held by earlier phases "
          f"{held / 1e9:.3f} GB", flush=True)
    return {"launches": launched, "check": check, "no_overlap": seq, "default": default,
            "max_abs_err": worst, "seconds": secs}


# -- phase 18: the LM dry-run, the roofline and the quantized collectives -------

# One combination of each input shape and each family (dense, vlm, moe,
# hybrid, ssm, audio) through the LM dry-run's entry point.
LM_DRYRUN = (("whisper-small", "decode_32k"), ("tinyllama-1.1b", "train_4k"),
             ("granite-moe-1b-a400m", "prefill_32k"), ("zamba2-2.7b", "long_500k"),
             ("xlstm-350m", "decode_32k"), ("qwen2-vl-2b", "decode_32k"))
LIVE_BAR = 0.10   # live-byte tracker's peak against the allocator's, relative
QC_WORKERS, QC_BITS = (4, 8), (8, 4)
QC_VALUES = 2**21   # a worker's gradient: 8 MB of fp32


def run_lm_dryrun(name: str, shape: str, dev, out: Path) -> dict:
    """``python -m repro_torch.launch.dryrun --arch NAME --shape SHAPE
    --device DEV --out OUT`` through its ``main``; the record read back.
    Fails unless it exits 0 with status ok."""
    from repro_torch.launch import dryrun

    argv = ["--arch", name, "--shape", shape, "--device", str(dev), "--out", str(out)]
    t0 = time.perf_counter()
    try:
        dryrun.main(argv)
        code = 0
    except SystemExit as e:
        code = e.code
    secs = time.perf_counter() - t0
    path = out / f"{name}__{shape}__16x16.json"
    rec = json.loads(path.read_text()) if path.exists() else {}
    if code != 0 or rec.get("status") != "ok":
        fail(f"lm dryrun {' '.join(argv)}: exit {code}, {rec.get('error')}")
    rec["seconds"] = secs
    return rec


def live_bytes_check(label: str, fn, held, dev) -> dict:
    """``fn()`` once to warm up, then again under ``hlo_stats.LiveBytes``
    (``held`` left out): its peak against ``torch.cuda.max_memory_allocated``
    above what was allocated just before, within LIVE_BAR."""
    import torch

    from repro_torch.launch.hlo_stats import LiveBytes

    fn()
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    tracker = LiveBytes(held)
    with tracker:
        out = fn()
    torch.cuda.synchronize(dev)
    real = torch.cuda.max_memory_allocated(dev) - before
    del out
    rel = abs(tracker.peak - real) / max(real, 1)
    print(f"[lm-dryrun] live bytes, {label}: tracker peak {tracker.peak / 1e9:.4f} GB, "
          f"max_memory_allocated above what was held {real / 1e9:.4f} GB "
          f"(relative difference {rel:.4f}; bar {LIVE_BAR})", flush=True)
    if not rel <= LIVE_BAR:
        fail(f"live-byte tracker on {label}: {tracker.peak} B against {real} B")
    return {"tracker_bytes": tracker.peak, "allocated_bytes": real, "relative": rel}


def live_bytes_phase(dev) -> dict:
    """The tracker behind a record's temp_size_in_bytes against the caching
    allocator on real steps: whisper-small serve_step (batch 16, cache 4096)
    and tinyllama-1.1b train_step over one sequence of 4096 tokens."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import init_cache, init_params, serve_step, train_step
    from repro_torch.optim import adamw_init
    from repro_torch.utils.trees import tree_leaves

    out = {}
    cfg = get_arch("whisper-small")
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    cache = init_cache(cfg, 16, 4096, device=dev)
    tokens = torch.zeros((16, 1), dtype=torch.int32, device=dev)

    def serve():
        with torch.no_grad():
            return serve_step(params, cache, tokens, cfg)

    out["whisper-small serve_step"] = live_bytes_check(
        "whisper-small serve_step, batch 16, cache 4096", serve,
        tree_leaves((params, cache, tokens)), dev)
    del params, cache
    cfg = get_arch("tinyllama-1.1b")
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    opt = adamw_init(params)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 4096), device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(1))}

    def step():
        return train_step(params, opt, batch, cfg)

    out["tinyllama-1.1b train_step"] = live_bytes_check(
        "tinyllama-1.1b train_step, 1 x 4096 tokens", step,
        tree_leaves((params, opt.mu, opt.nu, batch)), dev)
    del params, opt
    torch.cuda.empty_cache()
    return out


def quantized_collectives_phase(dev) -> dict:
    """The three quantized collectives at P in QC_WORKERS and bits in QC_BITS
    on the card: the kernels' words, zeros and scales bitwise equal to the
    plain path's on the card, every result bitwise equal to the CPU's (the
    plain versions there) from the same uniforms. Launch counts are reset
    just before and read just after the card's calls."""
    import torch

    from repro_torch.kernels.ref import quant_pack_ref
    from repro_torch.sharding import (quantized_all_to_all, quantized_psum,
                                      quantized_psum_tree)
    from repro_torch.sharding import quantized_collectives as qc

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(18)
    cases = []
    for p in QC_WORKERS:
        n = QC_VALUES
        rows = (n + (-n) % (p * 512)) // 128
        g = torch.randn((p, n), generator=gen)
        x = torch.randn((p, p * 256, 256), generator=gen)
        tree = {"w": torch.randn((p, 1000, 300), generator=gen),
                "b": torch.randn((p, 300), generator=gen)}
        leaf_rows = [(t[0].numel() + (-t[0].numel()) % (p * 512)) // 128
                     for t in (tree["b"], tree["w"])]          # sorted keys: b, w
        for bits in QC_BITS:
            cases.append(dict(
                p=p, bits=bits, g=g, x=x, tree=tree,
                u1=torch.rand((p, rows, 128), generator=gen),
                u2=torch.rand((p, rows // p, 128), generator=gen),
                u=torch.rand(x.shape, generator=gen),
                us=[(torch.rand((p, r, 128), generator=gen),
                     torch.rand((p, r // p, 128), generator=gen)) for r in leaf_rows]))

    def on(c, d):
        to = lambda t: t.to(d)
        return (quantized_psum(to(c["g"]), bits=c["bits"], u1=to(c["u1"]), u2=to(c["u2"])),
                quantized_all_to_all(to(c["x"]), bits=c["bits"], u=to(c["u"])),
                quantized_psum_tree({k: to(v) for k, v in c["tree"].items()},
                                    bits=c["bits"],
                                    us=[(to(a), to(b)) for a, b in c["us"]]))

    reset_counts()
    card = [on(c, dev) for c in cases]
    torch.cuda.synchronize(dev)
    launched = counts()
    for c, got in zip(cases, card):
        p, bits = c["p"], c["bits"]
        # The words that cross the worker axis: the kernel's against the
        # plain version's on the card.
        rows = c["u1"].shape[1]
        xg = torch.nn.functional.pad(c["g"], (0, rows * 128 - c["g"].shape[1])).to(dev)
        kernel = qc._quantize(xg.reshape(p, rows, 128), c["u1"].to(dev), bits)
        plain = quant_pack_ref(xg.reshape(p * rows, 128), c["u1"].to(dev).reshape(-1, 128),
                               bits)
        for k, (a, b) in enumerate(zip(kernel, plain)):
            if not torch.equal(a.reshape(b.shape), b):
                fail(f"quantized_psum P={p} bits={bits}: the kernel's "
                     f"{('words', 'zeros', 'scales')[k]} differ from the plain path's")
        host = on(c, torch.device("cpu"))
        for what, a, b in (("quantized_psum", got[0], host[0]),
                           ("quantized_all_to_all", got[1], host[1]),
                           *((f"quantized_psum_tree[{k}]", got[2][k], host[2][k])
                             for k in host[2])):
            if not torch.equal(a.cpu(), b):
                fail(f"{what} P={p} bits={bits}: the card's result differs from the "
                     f"CPU's by {float((a.cpu() - b).abs().max()):.3e}")
        err = float((host[0][0] - c["g"].sum(0)).abs().max())
        print(f"[qc] P={p} bits={bits}: psum of {c['g'].shape[1]} values a worker, "
              f"all-to-all of {tuple(c['x'].shape)}, tree of 2 leaves: words, zeros and "
              f"scales = the plain path's on the card, results = the CPU's bitwise; "
              f"psum max abs err against the exact sum {err:.4e}", flush=True)
    print(f"[qc] kernel launches on the collectives' path ({len(cases)} cases): "
          + ", ".join(f"{k} {v}" for k, v in launched.items())
          + f"; {time.perf_counter() - t0:.1f} s", flush=True)
    for k in ("quant_pack", "dequant_unpack"):
        if launched[k] != 7 * len(cases):
            fail(f"the quantized collectives launched {k} {launched[k]} times, "
                 f"expected {7 * len(cases)}")
    return {"launches": launched}


def extrapolation_check(dev, name: str = "granite-moe-1b-a400m",
                        shape: str = "prefill_32k") -> None:
    """cost_extrapolate against a full-depth trace at 32k-token prefill (the
    CPU tests hold decode_32k and train_4k): ``name`` at full width, 4
    layer quanta deep, on ``dev``; FLOPs exactly, bytes within 1%."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    full = get_arch(name)
    arch = dryrun.reduced_arch(full, 4 * dryrun._layer_quantum(full))
    t0 = time.perf_counter()
    dryrun.get_arch = lambda n: arch
    try:
        mesh = make_production_mesh()
        est = dryrun.cost_extrapolate(name, shape, mesh, device=dev)["estimated_full"]
        exact, _ = dryrun.build_lowered(name, shape, mesh, device=dev)
    finally:
        dryrun.get_arch = get_arch
    rel = est["bytes accessed"] / exact["traffic_bytes"] - 1
    print(f"[lm-dryrun] cost_extrapolate at {arch.num_layers} layers of {name} x {shape}: "
          f"FLOPs {est['flops']:.6e} (full trace {exact['dot_flops']:.6e}), bytes "
          f"{est['bytes accessed']:.6e} (full trace {exact['traffic_bytes']:.6e}, "
          f"{rel:+.2e}); {time.perf_counter() - t0:.1f} s", flush=True)
    if est["flops"] != exact["dot_flops"] or abs(rel) >= 0.01:
        fail(f"cost_extrapolate on {name} x {shape} is not the full trace's")


def lm_dryrun_phase(dev) -> dict:
    """Phase 18: the LM dry-run's entry point on the card and on the CPU for
    LM_DRYRUN (launch counts reset before the card's runs and read after),
    the live-byte tracker against the allocator, the roofline over the
    card's records, and the quantized collectives."""
    import shutil

    import torch

    from repro_torch.launch import roofline

    t0 = time.perf_counter()
    base = ROOT / "build" / "lm_dryrun_torch"
    shutil.rmtree(base, ignore_errors=True)
    reset_counts()
    card = [run_lm_dryrun(name, shape, dev, base / "cuda") for name, shape in LM_DRYRUN]
    launched = counts()
    if any(launched.values()):
        fail(f"the LM dry-run launched kernels: {launched}")
    host = [run_lm_dryrun(name, shape, torch.device("cpu"), base / "cpu")
            for name, shape in LM_DRYRUN]
    for c, h in zip(card, host):
        for key, sub in (("hlo_analysis", "dot_flops"), ("hlo_analysis", "traffic_bytes"),
                         ("memory", "argument_size_in_bytes")):
            if c[key][sub] != h[key][sub]:
                fail(f"lm dryrun {c['arch']} x {c['shape']}: {sub} on the card "
                     f"{c[key][sub]}, on the CPU {h[key][sub]}")
        m = c["memory"]
        print(f"[lm-dryrun] {c['arch']} x {c['shape']} on {c['mesh']} ({c['kind']}, "
              f"nm {c['num_microbatches']}, window {c['window']}): per device "
              f"{c['hlo_analysis']['dot_flops']:.6e} FLOPs, "
              f"{c['hlo_analysis']['traffic_bytes']:.6e} bytes; argument "
              f"{m['argument_size_in_bytes']} B, output {m['output_size_in_bytes']} B, "
              f"temp {m['temp_size_in_bytes']} B (card); {c['seconds']:.2f} s on the card "
              f"device, {h['seconds']:.2f} s on the cpu device; FLOPs, bytes and "
              f"argument bytes equal", flush=True)
    print(f"[lm-dryrun] kernel launches on the LM dry-run path: "
          + ", ".join(f"{k} {v}" for k, v in launched.items()), flush=True)
    extrapolation_check(dev)
    live = live_bytes_phase(dev)
    roofline.main(["--records", str(base / "cuda")])
    qc = quantized_collectives_phase(dev)
    secs = time.perf_counter() - t0
    print(f"[lm-dryrun] phase 18 in {secs:.1f} s", flush=True)
    return {"launches": launched, "qc_launches": qc["launches"], "live": live,
            "records": card, "seconds": secs}


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


TIME_WARMUP, TIME_EPOCHS, TIME_BURSTS = 2, 12, 3


def time_tree(tree: Path, dev, smi: str) -> None:
    """``--time TREE``: phase 4's serving burst (3 times) and phase 7's
    stacked training epochs (2 warm-up, then 12 timed) on the checkout at
    TREE, so that two trees (a parent and its change) are timed by one
    harness in one call on one card. Prints the median epoch per epoch
    phase (the set of stale delayed stages) and the median QPS."""
    import numpy as np
    import torch

    sys.path.insert(0, str(tree.resolve() / "src"))
    from repro_torch.kernels import build

    if not Path(build.__file__).resolve().is_relative_to(tree.resolve()):
        fail(f"--time {tree}: imported repro_torch from {build.__file__}")
    build.build_all()
    from repro_torch.configs.serve_products_paper import serve_products_paper
    from repro_torch.configs.train_products_paper import train_products_paper
    from repro_torch.launch.serve import burst
    from repro_torch.run import build_session
    from repro_torch.serve import build_server

    server = build_server(serve_products_paper(), device=dev)
    rng = np.random.default_rng(0)
    n = server.graph.num_nodes
    qps = []
    for _ in range(TIME_BURSTS):
        server.serve_batch([[int(v)] for v in rng.integers(0, n, BATCH)])
        requests = [[int(v)] for v in rng.integers(0, n, SERVE_REQUESTS)]
        qps.append(SERVE_REQUESTS / burst(server, requests, BATCH)[2])
    del server

    session = build_session(train_products_paper(), device=dev)
    trainer = session.trainer
    by_phase = {}
    for i in range(TIME_WARMUP + TIME_EPOCHS):
        stale = ",".join(s.level for s in trainer.schedule.stages
                         if s.delayed and trainer.epoch % s.cd) or "refresh"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.train_epoch()
        torch.cuda.synchronize()
        if i >= TIME_WARMUP:
            by_phase.setdefault(stale, []).append((time.perf_counter() - t0) * 1e3)
    out = {"tree": str(tree), "qps": qps, "qps_median": statistics.median(qps),
           "epoch_ms": by_phase,
           "epoch_ms_median": {k: statistics.median(v) for k, v in by_phase.items()}}
    print(f"[time] {tree}: serving QPS {[round(q, 2) for q in qps]}, median "
          f"{out['qps_median']:.2f}; epoch ms median by phase (stale stages) "
          + ", ".join(f"{k} {v:.3f}" for k, v in out["epoch_ms_median"].items()),
          flush=True)
    print(json.dumps(out))
    print(smi)


def shard_map_only(dev, smi: str) -> None:
    """``--shard-map``: phases 1, 2 and 19, with the references phase 19
    holds itself to: phase 7's stacked losses (4 epochs of
    train_products_paper, stacked) and phase 12's multiproc run."""
    from repro_torch.configs.train_products_paper import train_products_paper
    from repro_torch.kernels import build
    from repro_torch.run import build_session

    build.build_all()
    session = build_session(train_products_paper(), device=dev)
    epochs = _timed_epochs(session, TRAIN_EPOCHS)
    stacked = {"epochs": epochs, "eval_acc": session.evaluate()}
    del session
    print(f"[train] stacked losses {[m['loss'] for m in epochs]}", flush=True)
    shard_map_phase(dev, stacked, multiproc_phase(dev, stacked))
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
    if sys.argv[1:2] == ["--time"]:
        return time_tree(Path(sys.argv[2]) if len(sys.argv) > 2 else ROOT, dev, smi)
    if sys.argv[1:2] == ["--experiments"]:
        return experiments(dev, smi)
    if sys.argv[1:2] == ["--tune"]:
        from repro_torch.kernels import build
        build.build_all()
        audit_tune_phase(dev)
        print(smi)
        return
    if sys.argv[1:2] == ["--lm"]:
        from repro_torch.kernels import build
        build.build_all()
        lm_phase(dev, smi)
        print(smi)
        return
    if sys.argv[1:2] == ["--lm-train"]:
        from repro_torch.kernels import build
        build.build_all()
        lm_train_phase(dev, smi)
        print(smi)
        return
    if sys.argv[1:2] == ["--dryrun"]:
        from repro_torch.kernels import build
        build.build_all()
        dryrun_phase(dev)
        print(smi)
        return
    if sys.argv[1:2] == ["--lm-dryrun"]:
        from repro_torch.kernels import build
        build.build_all()
        lm_dryrun_phase(dev)
        print(smi)
        return
    if sys.argv[1:2] == ["--shard-map"]:
        return shard_map_only(dev, smi)

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
    sm = shard_map_phase(dev, trained, multi)
    tuned = audit_tune_phase(dev)
    lm_phase(dev, smi)
    lm_trained = lm_train_phase(dev, smi)
    dry = dryrun_phase(dev)
    lm_dry = lm_dryrun_phase(dev)

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
        k["shard_map_max_abs_err"] = sm["checked"]["max_abs_err"][k["name"]]
        k["tune_max_abs_err"] = tuned["max_abs_err"][k["name"]]
        k["dryrun_max_abs_err"] = dry["max_abs_err"][k["name"]]
    paths = {"serve": {"seg_aggregate": served["launches"]}, "train": launches,
             "single_sage": single["launches"], "single_gat": gat["launches"],
             "gat_serve": gat_served["launches"], "ckpt_resume_serve": ckpt["launches"],
             "multiproc": multi["launches"], "shard_map": sm["launches"],
             "shard_map_lower": sm["lower_launches"], "tune": tuned["launches"],
             "lm_train": lm_trained["launches"], "dryrun": dry["launches"],
             "lm_dryrun": lm_dry["launches"], "quantized_collectives": lm_dry["qc_launches"]}
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
