"""The benchmark's run of one cell, driven by data.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
harness finds everything else by those names:

  configs/<config>.json     the model's sizes, its program entry and reference
  workloads/<traffic>.json  the graph, the partition and the exchange schedule
  limits/<cell>.json        the limit of each number the comparison reads
  programs/<program>.py     the program's entry, built and stepped
  reference/<reference>.py  the plain PyTorch/NumPy reference of the step
  metrics/<metric>.py       one reader per metric of BENCHMARK.json

One run: make the inputs from the seed; build the program; drive it
through its first three steps (checked against the reference later) and
so through every shape the window uses; measure ``--seconds`` of whole
schedule periods; with ``--trace 1`` profile a few more epochs; read the
device's peak memory; read where the program placed its rows; free the
program; run the reference over the same three steps and compare; print
the result line.
"""

from __future__ import annotations

import bisect
import gc
import importlib.util
import json
import math
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from gnnbench import compare, inputs, trees
from gnnbench.metrics_common import busy_seconds

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CHECKED_STEPS = 3
ADAM_B1 = 0.9


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``gnnbench/<kind>/<name>.py`` as a module (a metric reader, a
    program entry or a reference), found by its name alone."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"gnnbench.{kind}.{name.replace('-', '_').replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: Dict, name: str) -> Dict:
    """A workload entry with its configuration, traffic and limits loaded."""
    for w in bench["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    return {"name": name, "chips": w["chips"],
            "config": load_json(ROOT / entry["file"]),
            "traffic": load_json(HERE / "workloads" / f"{w['traffic']}.json"),
            "limits": load_json(HERE / "limits" / f"{name}.json")}


def cell_metrics(bench: Dict, name: str, trace: bool) -> List[Dict]:
    """The metrics a run of the cell reports: its end-to-end metrics with
    ``--trace 0``, its per-layer metrics with ``--trace 1``."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


# --------------------------------------------------------------------------
# The checked steps
# --------------------------------------------------------------------------


def checked_readings(prog, params0, steps: int = CHECKED_STEPS) -> Dict:
    """Drive the program through its first ``steps`` steps by the window's
    own call, reading what the comparison needs: each step's loss, the
    first gradient as the optimizer got it (AdamW's first moment after one
    step over 1 - b1) and each leaf's change after the last step."""
    losses, grad1 = [], None
    for i in range(steps):
        losses.append(prog.step())
        if i == 0:
            grad1 = {k: v / (1.0 - ADAM_B1) for k, v in trees.leaf_norms(prog.first_moment()).items()}
    return {"losses": losses, "grad_norms": grad1,
            "change_norms": trees.change_norms(prog.params(), params0)}


# --------------------------------------------------------------------------
# The traced epochs
# --------------------------------------------------------------------------


def profile_epoch(prog, sync) -> Dict:
    """One epoch under torch.profiler: its wall seconds, its device
    activities (name, start us, end us) and the host's operations."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        prog.step()
        sync()
        wall = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        r = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(r)
        else:
            host.append(r)
    return {"wall_s": wall, "device": dev, "host": host}


def idle_gaps(epoch: Dict, most: int = 200) -> List:
    """(host operation, seconds) of the ``most`` longest gaps between device
    activities, each named by the innermost host operation running when
    the gap opened."""
    ivs = sorted((s, e) for _, s, e in epoch["device"])
    host = sorted(epoch["host"], key=lambda r: r[1])
    starts = [r[1] for r in host]
    gaps, end = [], None
    for s, e in ivs:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:most]
    out = []
    for g0, g1 in gaps:
        label = "host"
        i = bisect.bisect_right(starts, g0) - 1
        while i >= 0:
            name, hs, he = host[i]
            if he >= g0:
                label = name
                break
            i -= 1
        out.append((label, (g1 - g0) * 1e-6))
    return out


def breakdown(traced: List[Dict]) -> Dict:
    ops: Dict[str, float] = {}
    gaps: Dict[str, float] = {}
    for ep in traced:
        for name, s, e in ep["device"]:
            ops[name] = ops.get(name, 0.0) + (e - s) * 1e-6
        for name, sec in idle_gaps(ep):
            gaps[name] = gaps.get(name, 0.0) + sec
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


# --------------------------------------------------------------------------
# One run
# --------------------------------------------------------------------------


def power_limit() -> Optional[str]:
    import shutil
    import subprocess
    if not shutil.which("nvidia-smi"):
        return None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: Optional[float] = None, bench: Optional[Dict] = None,
             shrink: Optional[Dict] = None, log=print) -> Dict:
    """One run of the cell ``name``: the result line's object. ``shrink``
    (tests only) overrides sizes of the configuration's graph section."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = benchmark() if bench is None else bench
    c = cell(bench, name)
    cfg, traffic = c["config"], c["traffic"]
    if shrink:
        cfg = {**cfg, "graph": {**cfg["graph"], **shrink}}
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        # The configurations state fp32 products: TF32 stays off.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    raw = inputs.make_graph({**cfg["graph"], **traffic.get("graph", {})},
                            cfg["model"]["num_classes"], cfg["model"]["in_dim"], seed)
    params0 = inputs.make_params(cfg["model"], seed, dev)
    entry = load_module("programs", cfg["program"])
    prog = entry.Program(cfg, traffic, raw, trees.clone(params0),
                          inputs.Draws(seed), seed, dev)
    checked = checked_readings(prog, params0)
    sync()
    setup_s = time.perf_counter() - t_start
    log(f"[gnnbench] {name} seed {seed}: set-up {setup_s:.3f} s "
        f"(partition {prog.partition_s:.3f} s); losses {checked['losses']}")

    # The window: whole schedule periods, at least ``seconds`` long.
    epochs: List = []
    failed = 0
    w0 = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        kind = prog.epoch_kind()
        failed += not math.isfinite(prog.step())
        epochs.append((kind, time.perf_counter() - t0))
        now = time.perf_counter()
        if now - w0 >= seconds and len(epochs) % prog.period == 0:
            break
    window_s = time.perf_counter() - w0

    traced = []
    if trace:
        for _ in range(prog.traced_epochs):
            kind = prog.epoch_kind()
            ep = profile_epoch(prog, sync)
            ep["kind"] = kind
            traced.append(ep)
        if hasattr(prog, "recording"):
            # One more refresh epoch (the traced ones were whole periods),
            # with the program's record of what its wire delivered.
            with prog.recording():
                prog.step()
    sync()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    facts = prog.facts()
    placement = prog.placement()
    prog.close()
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    reference = load_module("reference", cfg["reference"])
    t_ref = time.perf_counter()
    ref = reference.run(cfg, traffic, raw, params0, inputs.Draws(seed), seed, dev,
                        steps=CHECKED_STEPS, placement=placement)
    sync()
    ref_s = time.perf_counter() - t_ref
    numbers = compare.numbers(checked, ref)
    verdict = compare.judge(numbers, c["limits"])
    log(f"[gnnbench] reference {ref_s:.3f} s; losses {ref['losses']}")

    ctx = {"cell": c, "config": cfg, "traffic": traffic, "raw": raw,
           "facts": facts, "epochs": epochs, "window_s": window_s,
           "setup_s": setup_s, "peak_bytes": peak, "traced": traced,
           "device_kind": torch.cuda.get_device_name(dev) if cuda else "cpu"}
    metrics = {}
    for m in cell_metrics(bench, name, trace):
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": verdict["correct"] and not failed,
              "attempted": len(epochs), "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": ctx["device_kind"],
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace and traced:
        result["device"]["busy_s"] = busy_seconds(traced)
        result["device"]["window_s"] = sum(ep["wall_s"] for ep in traced)
        result["breakdown"] = breakdown(traced)
    result["power"] = power_limit() if cuda else None
    result["reference_s"] = ref_s
    result["compared"] = verdict["compared"]
    return result
