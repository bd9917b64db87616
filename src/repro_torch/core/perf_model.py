"""Communication performance model (paper §5.4 Eqn 2, §6.2 Eqns 3–8).

Drives the scaling benchmarks (Figs 7, 9, 10 analogues): given *measured*
per-pair communication volumes from the partitioner/MVC pipeline and
hardware constants, predict epoch communication time with and without the
quantization scheme, and the speedup curve vs process count.

Hardware presets: the paper's two machines plus the TPU-v5e target this
codebase compiles for (DESIGN.md §3).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    bw_comm: float    # bytes/s per worker link
    latency: float    # seconds per message
    th_cal: float     # bytes/s effective local compute streaming throughput

    @property
    def beta(self) -> float:
        """β = TH_cal / BW_comm (paper: ~O(10^2))."""
        return self.th_cal / self.bw_comm


# Registry: every call site used to pin FUGAKU_A64FX; modelled rows now
# name their machine (``--hw`` on the benchmark CLIs, ``hw=`` through the
# sweep engine). ``"measured"`` resolves lazily to a spec probed on the
# machine actually running the model (see :func:`measure_local_hardware`).
HARDWARE: Dict[str, HardwareSpec] = {}


def register_hardware(hw: HardwareSpec) -> HardwareSpec:
    HARDWARE[hw.name] = hw
    return hw


ABCI_XEON = register_hardware(
    HardwareSpec("abci-xeon6148", bw_comm=12.5e9, latency=2e-6, th_cal=200e9))
FUGAKU_A64FX = register_hardware(
    HardwareSpec("fugaku-a64fx", bw_comm=6.8e9, latency=1e-6, th_cal=1024e9))
TPU_V5E = register_hardware(
    HardwareSpec("tpu-v5e-ici", bw_comm=50e9, latency=1e-6, th_cal=819e9))

_MEASURED: Dict[str, HardwareSpec] = {}


def measure_local_hardware(size_mb: int = 64, iters: int = 3,
                           name: str = "measured") -> HardwareSpec:
    """Probe THIS host into a :class:`HardwareSpec`.

    The multiproc runtime's "wire" is the shared-memory mailbox fabric, so
    the local analogue of ``bw_comm`` is a post+collect through memory —
    two passes over the payload — and ``latency`` is the software overhead
    of shipping a tiny (one cache line) message. ``th_cal`` is the
    streaming copy bandwidth the Eqn-3/4 compute terms assume. All three
    are medians over ``iters`` trials so one scheduler hiccup can't skew
    the calibration.
    """
    n = size_mb * (1 << 20) // 4
    src = np.ones(n, np.float32)
    dst = np.empty_like(src)
    mailbox = np.empty_like(src)

    def _med(fn, passes):
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return passes * src.nbytes / float(np.median(ts))

    dst[:] = src  # touch/fault pages before timing
    # Streaming compute throughput: one read + one write per element.
    th_cal = _med(lambda: np.copyto(dst, src), passes=2)

    # Mailbox "wire": sender posts into the shared segment, receiver
    # collects out of it — payload bytes cross memory twice, so effective
    # per-link wire bandwidth is half a copy's.
    def _post_collect():
        np.copyto(mailbox, src)
        np.copyto(dst, mailbox)

    bw_comm = _med(_post_collect, passes=1)

    tiny_src = np.zeros(16, np.float32)   # one 64-byte mailbox slot
    tiny_dst = np.empty_like(tiny_src)
    lat = []
    for _ in range(max(iters, 3)):
        t0 = time.perf_counter()
        for _ in range(1000):
            np.copyto(tiny_dst, tiny_src)
        lat.append((time.perf_counter() - t0) / 1000)
    return HardwareSpec(name, bw_comm=bw_comm,
                        latency=float(np.median(lat)), th_cal=th_cal)


def get_hardware(name: str) -> HardwareSpec:
    """Resolve a hardware name: a registered preset, or ``"measured"``
    (probed once per process and cached)."""
    if name in HARDWARE:
        return HARDWARE[name]
    if name == "measured":
        if name not in _MEASURED:
            _MEASURED[name] = measure_local_hardware()
        return _MEASURED[name]
    raise KeyError(f"unknown hardware {name!r}; known: "
                   f"{sorted(HARDWARE) + ['measured']}")


BIT_FP32 = 32


def comm_time_matrix(volume_rows: np.ndarray, feat_dim: int, hw: HardwareSpec,
                     bits: int = BIT_FP32) -> np.ndarray:
    """T_comm^{i,j} (Eqn 2 upper): per-pair transfer time + latency."""
    bytes_ij = volume_rows * feat_dim * bits / 8.0
    t = bytes_ij / hw.bw_comm
    t = t + (volume_rows > 0) * hw.latency
    return t


def comm_time(volume_rows: np.ndarray, feat_dim: int, hw: HardwareSpec,
              bits: int = BIT_FP32) -> float:
    """T_comm (Eqn 2 lower): bottleneck worker = max_i sum_j T^{i,j}."""
    t = comm_time_matrix(volume_rows, feat_dim, hw, bits)
    return float(t.sum(axis=1).max()) if t.size else 0.0


def quant_comm_time(volume_rows: np.ndarray, feat_dim: int, hw: HardwareSpec,
                    bits: int, subgraph_rows: np.ndarray,
                    row_group: int = 4) -> float:
    """T_quant_comm (Eqn 6): pre-quant + quant + wire + params + dequant."""
    P = volume_rows.shape[0]
    # Eqn 3: masked LP + LayerNorm over the local subgraph (no extra comm).
    t_pre = subgraph_rows * feat_dim * 4.0 / hw.th_cal
    # Eqn 4: quant reads fp32 + writes intX; dequant symmetric.
    bytes_rw = volume_rows * feat_dim * (BIT_FP32 + bits) / 8.0
    t_quant = bytes_rw / hw.th_cal
    t_dequant = t_quant.T
    # Eqn 5: quantized payload + fp32 (zero, scale) per row group.
    payload = volume_rows * feat_dim * bits / 8.0
    params = np.ceil(volume_rows / row_group) * 2 * 4.0
    t_wire = (payload + params) / hw.bw_comm + (volume_rows > 0) * hw.latency
    per_worker = t_pre + (t_quant + t_wire + t_dequant).sum(axis=1)
    return float(per_worker.max()) if per_worker.size else 0.0


def speedup_model(alpha: float, beta: float, gamma: float, delta: float) -> float:
    """Eqn 8: closed-form speedup of quantized over fp32 communication."""
    num = alpha * beta * (gamma + delta)
    den = (1 + delta) * alpha * beta + 2 * alpha * (1 + gamma) + beta * gamma
    return num / den


def delta_ratio(volume_rows: float, feat_dim: int, bits: int, hw: HardwareSpec) -> float:
    """δ = L_comm / (per-pair quantized transfer time); →∞ when latency-bound."""
    transfer = volume_rows * feat_dim * bits / 8.0 / hw.bw_comm
    return hw.latency / max(transfer, 1e-30)


def _compute_terms(local_nnz, owned_rows, feat_dim: int, hidden_dim: int,
                   num_layers: int, hw: HardwareSpec):
    """Streaming-bound compute terms shared by the epoch-time models:
    aggregation reads nnz * F, the NN op rows * F * H MACs (the paper's
    CPU regime). Returns (t_aggr, t_nn) for the bottleneck worker x L."""
    local_nnz = np.asarray(local_nnz, dtype=np.float64)
    owned_rows = np.asarray(owned_rows, dtype=np.float64)
    f = max(feat_dim, hidden_dim)
    t_aggr = float((local_nnz * f * 4.0 / hw.th_cal).max()) * num_layers
    flops = owned_rows * f * hidden_dim * 2.0
    t_nn = float((flops / (hw.th_cal * 4.0)).max()) * num_layers
    return t_aggr, t_nn


def epoch_time_model(
    volume_rows: np.ndarray,     # [P, P] feature rows on the wire
    local_nnz: np.ndarray,       # [P] local aggregation edges per worker
    owned_rows: np.ndarray,      # [P] owned nodes per worker
    feat_dim: int,
    hidden_dim: int,
    num_layers: int,
    hw: HardwareSpec,
    bits: int = 0,
) -> dict:
    """Full-epoch time split into the Fig-12 components (per GCN layer x L).

    Compute terms via :func:`_compute_terms`; comm via Eqns 2/6.
    """
    f = max(feat_dim, hidden_dim)
    t_aggr, t_nn = _compute_terms(local_nnz, owned_rows, feat_dim,
                                  hidden_dim, num_layers, hw)
    if bits == 0:
        t_comm = comm_time(volume_rows, f, hw) * num_layers
        t_quant = 0.0
    else:
        full = quant_comm_time(volume_rows, f, hw, bits, owned_rows) * num_layers
        wire_only = comm_time(volume_rows, f, hw, bits) * num_layers
        t_comm = wire_only
        t_quant = max(full - wire_only, 0.0)
    # Sync: load imbalance — difference between max and mean compute.
    per_worker_compute = local_nnz * f * 4.0 / hw.th_cal
    t_sync = float(per_worker_compute.max() - per_worker_compute.mean()) * num_layers
    total = t_aggr + t_nn + t_comm + t_quant + t_sync
    return {"aggr": t_aggr, "nn": t_nn, "comm": t_comm, "quant": t_quant,
            "sync": t_sync, "total": total}


def hier_epoch_time(
    intra_bytes: float,          # per-layer intra-stage wire bytes
    inter_bytes: float,          # per-layer inter-stage wire bytes
    local_nnz,                   # [P] local aggregation edges per worker
    owned_rows,                  # [P] owned nodes per worker
    feat_dim: int,
    hidden_dim: int,
    num_layers: int,
    hw: HardwareSpec,
    intra_bw_factor: float = 8.0,
) -> dict:
    """Two-level epoch-time model with and without wire/compute overlap.

    Compute terms follow :func:`epoch_time_model`'s streaming
    approximations; the wire terms take the schedule's per-stage predicted
    bytes (``ExchangeSchedule.wire_volume_bytes`` — Eqns 2/5/6 with the
    per-stage bits/cd already folded in). The intra stage rides the
    in-node fabric at ``intra_bw_factor * bw_comm``; the inter stage rides
    the slow wire at ``bw_comm``.

    ``sequential`` serializes every term — the pre-overlap ``run_layer``
    trace. ``overlap`` models the two-phase LayerProgram: the inter-group
    pipeline is in flight during the local bucketed aggregation *and* the
    intra exchange, so only its exposed remainder
    ``max(0, t_inter - (t_aggr + t_intra))`` adds to the critical path —
    the Eqn-8 regime where quantization (shrinking t_inter) and overlap
    (hiding it) compose to keep strong scaling alive past 1k workers.
    """
    t_aggr, t_nn = _compute_terms(local_nnz, owned_rows, feat_dim,
                                  hidden_dim, num_layers, hw)
    t_intra = intra_bytes / (hw.bw_comm * intra_bw_factor) * num_layers
    t_inter = inter_bytes / hw.bw_comm * num_layers
    sequential = t_aggr + t_nn + t_intra + t_inter
    exposed = max(0.0, t_inter - (t_aggr + t_intra))
    overlap = t_aggr + t_nn + t_intra + exposed
    return {
        "aggr": t_aggr, "nn": t_nn, "intra": t_intra, "inter": t_inter,
        "sequential": sequential, "overlap": overlap,
        "inter_hidden_fraction": round(
            1.0 - exposed / t_inter, 4) if t_inter else 1.0,
    }
