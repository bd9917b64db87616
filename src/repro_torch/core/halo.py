"""Halo exchange in one call: the communication stage of distributed
full-batch GCN (Fig 2 steps 4-6), counterpart of ``repro/core/halo.py``.

One exchange per GCN layer: assemble the send buffers (raw covered-source
rows plus pre-aggregated partials, per destination chunk), optionally
quantize them stochastically (payload plus fp32 zero/scale per 4-row
group), all_to_all, dequantize, and scatter-add the received rows into the
local aggregation.

The machinery lives in :mod:`repro_torch.core.exchange` (plans, the fp32
and quantized wires, the two-phase ``LayerProgram`` the trainer runs).
These wrappers are its single-call form: each stage assembles, exchanges
and returns in one step, with no overlap window. As there, every tensor
stacks the P workers on a leading axis (``[P, rows, F]``; worker
``p = g * W + w`` in the hierarchical G x W layout), and the randomness
of a quantized wire is passed in: the JAX package takes a PRNG key, the
port takes the uniforms (see ``core.exchange``).

The hierarchical exchange (the paper's contribution 2) runs the intra
level as a flat all_to_all over the W workers of each group and the inter
level as psum_scatter over the group's workers -> all_to_all across the G
groups -> all_gather back to the group's workers.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.exchange import (
    DeviceHaloPlan,
    DeviceHierPlan,
    StageTopo,
    assemble_send,
    scatter_recv,
    stack_halo_plan,
    stack_hier_plan,
    stage_exchange,
)

__all__ = [
    "DeviceHaloPlan",
    "DeviceHierPlan",
    "stack_halo_plan",
    "stack_hier_plan",
    "assemble_send",
    "scatter_recv",
    "halo_exchange_fp32",
    "halo_exchange",
    "aggregate_with_halo",
    "halo_exchange_hierarchical",
    "aggregate_with_halo_hierarchical",
]

# noise(backward, shape) -> [P, rows, F] uniforms in [0, 1) for one wire
StageNoise = Callable[[bool, Tuple[int, ...]], torch.Tensor]
# noise(stage, backward, shape): stage 0 is the intra level, 1 the inter level
HierNoise = Callable[[int, bool, Tuple[int, ...]], torch.Tensor]


def _flat_topo(axis_name: str, nparts: int) -> StageTopo:
    return StageTopo("a2a", axis_name, nparts, lead=(1, nparts), wire_dim=1)


def halo_exchange_fp32(h: torch.Tensor, plan: DeviceHaloPlan, axis_name: str,
                       nparts: int) -> torch.Tensor:
    """FP32 flat exchange: returns the received [P, P*R, F] buffers."""
    return stage_exchange(assemble_send(h, plan), _flat_topo(axis_name, nparts), 0)


def halo_exchange(h: torch.Tensor, plan: DeviceHaloPlan, axis_name: str,
                  nparts: int, *, bits: int = 0,
                  noise: Optional[StageNoise] = None) -> torch.Tensor:
    """Full flat exchange: assemble -> (quantize) -> all_to_all ->
    (dequantize). ``bits=0`` is the fp32 wire (the paper's baseline); bits
    in {2, 4, 8} quantize it with the stochastic-rounding uniforms
    ``noise`` gives."""
    if bits and noise is None:
        raise ValueError("quantized halo exchange needs stochastic-rounding noise")
    return stage_exchange(assemble_send(h, plan), _flat_topo(axis_name, nparts),
                          bits, noise)


def aggregate_with_halo(h: torch.Tensor, local_agg: torch.Tensor,
                        plan: DeviceHaloPlan, axis_name: str, nparts: int, *,
                        bits: int = 0, noise: Optional[StageNoise] = None
                        ) -> torch.Tensor:
    """Local aggregation + remote pre/post contributions -> full AGGREGATE."""
    recv = halo_exchange(h, plan, axis_name, nparts, bits=bits, noise=noise)
    return scatter_recv(local_agg, recv, plan)


def halo_exchange_hierarchical(h: torch.Tensor, plan: DeviceHierPlan,
                               node_axis: str, group_axis: str, group_size: int,
                               num_groups: int, *, bits: int = 0,
                               noise: Optional[HierNoise] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-level exchange. Returns (intra recv buffers [P, W*R_i, F], inter
    recv buffers [P, G*R_e, F]). ``bits`` quantizes both wires; ``noise``
    draws each level's uniforms (the JAX package folds 1 and 2 into its
    key for the two levels)."""
    if bits and noise is None:
        raise ValueError("quantized hierarchical halo exchange needs "
                         "stochastic-rounding noise")
    lead = (num_groups, group_size)
    topo_i = StageTopo("a2a", node_axis, group_size, lead=lead, wire_dim=1)
    topo_e = StageTopo("grouped", group_axis, num_groups, node_axis, group_size,
                       lead=lead, wire_dim=0)
    ni = ne = None
    if noise is not None:
        ni = lambda backward, shape: noise(0, backward, shape)
        ne = lambda backward, shape: noise(1, backward, shape)
    recv_i = stage_exchange(assemble_send(h, plan.intra), topo_i, bits, ni)
    recv_e = stage_exchange(assemble_send(h, plan.inter), topo_e, bits, ne)
    return recv_i, recv_e


def aggregate_with_halo_hierarchical(h: torch.Tensor, local_agg: torch.Tensor,
                                     plan: DeviceHierPlan, node_axis: str,
                                     group_axis: str, group_size: int,
                                     num_groups: int, *, bits: int = 0,
                                     noise: Optional[HierNoise] = None
                                     ) -> torch.Tensor:
    """Local aggregation + two-level remote contributions -> full AGGREGATE."""
    recv_i, recv_e = halo_exchange_hierarchical(
        h, plan, node_axis, group_axis, group_size, num_groups, bits=bits,
        noise=noise)
    acc = scatter_recv(local_agg, recv_i, plan.intra)
    return scatter_recv(acc, recv_e, plan.inter)
