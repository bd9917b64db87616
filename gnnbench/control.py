"""Readings behind the limits of ``limits/<cell>.json``, at a cell's own
size:

    python3 gnnbench/control.py --workload <name> --seeds 1,2,3 [--faults a,b] [--fault-seeds n] [--fp64]

For each seed it prints one JSON line with the numbers of ``compare`` for
the program's first three steps (and each leaf's norms on both sides),
for the control (the reference computed in TF32, put in the program's
place, against the reference in fp32), with ``--faults`` for the
program with each named fault of ``faults.py`` planted (on the first
``--fault-seeds`` seeds),
and with ``--fp64`` for the reference, the program and the control each
against the reference computed in float64 (a witness of how far fp32
rounding alone moves each number). No measured window: training's
readings need none. ``--device cpu`` and ``--nodes`` run it small.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


_CACHES: dict = {}


def readings(name: str, seed: int, device: str, faults=(), fp64: bool = False,
             nodes=None) -> dict:
    import torch

    from gnnbench import compare, harness, inputs, trees
    from gnnbench import faults as F

    c = harness.cell(harness.benchmark(), name)
    cfg, traffic = c["config"], c["traffic"]
    if nodes:
        cfg = {**cfg, "graph": {**cfg["graph"], "num_nodes": nodes}}
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    raw = inputs.make_graph({**cfg["graph"], **traffic.get("graph", {})},
                            cfg["model"]["num_classes"], cfg["model"]["in_dim"], seed)
    params0 = inputs.make_params(cfg["model"], seed, dev)
    reference = harness.load_module("reference", cfg["reference"])
    entry = harness.load_module("programs", cfg["program"])
    out = {"seed": seed}
    # One cell's graph is the same for every seed: its partition is built once.
    cache = _CACHES.setdefault((name, nodes), getattr(entry, "shared_partition", lambda: None)())

    def prog_readings(fault=None, placement=False):
        with (F.FAULTS[fault]() if fault else contextlib.nullcontext()):
            prog = entry.Program(cfg, traffic, raw, trees.clone(params0),
                                  inputs.Draws(seed), seed, dev, build_cache=cache)
            got = harness.checked_readings(prog, params0)
            where = prog.placement()
            prog.close()
        return (got, where) if placement else got

    got, placement = prog_readings(placement=True)
    L = reference.prepare(cfg, traffic, raw, seed, dev, placement)
    ref = reference.train(L, cfg, params0, inputs.Draws(seed), harness.CHECKED_STEPS)
    ctl = reference.train(L, cfg, params0, inputs.Draws(seed), harness.CHECKED_STEPS,
                          control=True)
    out["control"] = compare.numbers(ctl, ref)
    if fp64:
        wide = reference.train(L, cfg, params0, inputs.Draws(seed), harness.CHECKED_STEPS,
                               dtype=torch.float64)
        out["reference_vs_fp64"] = compare.numbers(ref, wide)
        out["control_vs_fp64"] = compare.numbers(ctl, wide)
        out["control_leaves"] = _leaves(ref, ctl)
    del L
    out["program"] = compare.numbers(got, ref)
    out["leaves"] = _leaves(ref, got)
    if fp64:
        out["program_vs_fp64"] = compare.numbers(got, wide)
    if faults:
        out["faults"] = {f: compare.numbers(prog_readings(f), ref) for f in faults}
    return out


def _leaves(ref, got) -> dict:
    """Each leaf's (reference, other side) first-gradient and change norms."""
    return {k: [ref["grad_norms"][k], got["grad_norms"][k],
                ref["change_norms"][k], got["change_norms"][k]] for k in ref["grad_norms"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=1 << 30)
    ap.add_argument("--fp64", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=0)
    args = ap.parse_args(argv)
    faults = [f for f in args.faults.split(",") if f]
    for i, s in enumerate(args.seeds.split(",")):
        t0 = time.perf_counter()
        r = readings(args.workload, int(s), args.device,
                     faults if i < args.fault_seeds else (), args.fp64, args.nodes or None)
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
