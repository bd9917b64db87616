"""The port's GCN dry-run (``repro_torch.launch.dryrun --gcn``) and its
step statistics (``repro_torch.launch.hlo_stats``) against the JAX
package's.

The JAX package's ``repro.launch.dryrun`` sets a 512-device ``XLA_FLAGS``
when imported, so its side runs in a subprocess; the port's runs here on
the CPU at the ``make check-overlap`` size (rmat-10, 8 workers, 2 groups).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core.record import LoweredStep, StepOp
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch.hlo_stats import analyze_step, parse_collectives
from repro_torch.run import build_session

ROOT = Path(__file__).resolve().parents[1]
CHECK_OVERLAP = ["--gcn", "--groups", "2", "--scale", "10", "--chips", "8",
                 "--overlap", "--assert-overlap"]
FIELDS = ("arch", "shape", "mesh", "chips", "status", "spec", "spec_hash",
          "agg_backend", "schedule", "predicted_wire_bytes", "collective_order",
          "collectives", "comm_stats", "cost", "memory")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the test runner runs several workers side by
    side, and PyTorch's CPU thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(groups: int = 2, overlap=True):
    sets = [f"partition.groups={groups}"]
    if overlap is not None:
        sets.append(f"schedule.overlap={json.dumps(overlap)}")
    return tdryrun.gcn_base_spec(8, scale=10).with_overrides(sets)


@pytest.fixture(scope="module")
def records():
    """The port's dry-run records on the CPU, by ``schedule.overlap``."""
    return {ov: tdryrun.run_gcn_dryrun(_spec(overlap=ov), save=False, device="cpu")
            for ov in (True, False)}


def _env(**extra):
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1", **extra)


REFERENCE = """
import json
from repro.launch.dryrun import gcn_base_spec
from repro.run import build_session
spec = gcn_base_spec(8, scale=10).with_overrides(
    ["partition.groups=2", "schedule.overlap=true"])
s = build_session(spec)
print(json.dumps({"spec": spec.to_dict(), "hash": spec.content_hash(),
                  "schedule": s.schedule.describe(),
                  "predicted": s.predicted_wire_bytes(),
                  "stats": s.pg.stats.as_dict()}))
"""


def test_base_spec_and_host_record_match_the_reference(records):
    proc = subprocess.run([sys.executable, "-c", REFERENCE], env=_env(),
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    spec = _spec()
    assert spec.to_dict() == ref["spec"]
    assert spec.content_hash() == ref["hash"]
    rec = records[True]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["spec"] == ref["spec"] and rec["spec_hash"] == ref["hash"]
    assert "lowered_as" not in rec                   # the base spec is shard_map:
    assert rec["ranks"] == 8                         # its ranks' programs
    assert rec["schedule"] == ref["schedule"]
    assert rec["predicted_wire_bytes"] == ref["predicted"]
    assert rec["comm_stats"] == ref["stats"]


@pytest.mark.parametrize("overlap", [True, False])
def test_overlap_flags_follow_the_schedule(records, overlap):
    order = records[overlap]["collective_order"]
    assert order["wire_before_compute"] is overlap
    assert order["inter_wire_before_compute"] is overlap
    assert order["num_events"] >= len(order["events"]) > 0


def test_assert_overlap_fails_a_schedule_with_no_overlapped_stage(tmp_path):
    rec = tdryrun.run_gcn_dryrun(_spec(groups=0, overlap=None), save=False,
                                 assert_overlap=True, device="cpu")
    assert rec["status"] == "error"
    assert "no stage of the resolved schedule overlaps" in rec["error"]
    argv = [a for a in CHECK_OVERLAP if a != "--overlap"]
    argv[argv.index("--groups") + 1] = "0"
    with pytest.raises(SystemExit) as exc:
        tdryrun.main(argv + ["--device", "cpu", "--out", str(tmp_path)])
    assert exc.value.code == 1
    saved = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert saved["status"] == "error" and saved["shape"] == "rmat10-fullbatch"


def test_assert_overlap_records_the_rules_findings_before_it_fails(monkeypatch):
    """An ``overlap-order`` error fails the record, and the rule's findings
    are in it (a stand-in rule reports one error)."""
    from repro_torch.analysis import hlo_rules
    from repro_torch.analysis.rules import Finding, Severity

    finding = Finding(rule="overlap-order", severity=Severity.ERROR,
                      message="wire posted after the aggregation")
    monkeypatch.setattr(hlo_rules.OverlapOrderRule, "check", lambda self, ctx: [finding])
    rec = tdryrun.run_gcn_dryrun(_spec(), save=False, assert_overlap=True, device="cpu")
    assert rec["status"] == "error"
    assert "wire posted after the aggregation" in rec["error"]
    assert rec["audit_findings"] == [finding.as_dict()]


@pytest.mark.parametrize("overlap", [True, False])
def test_recorded_all_to_all_bytes_equal_the_prediction(records, overlap):
    spec = _spec(overlap=overlap).with_overrides(["exec.mode=vmap"])
    predicted = build_session(spec, device="cpu").predicted_hlo_wire_bytes()
    rec = records[overlap]
    # Epoch 0 refreshes every stage, so every stage's wire ran.
    stages = [s["level"] for s in rec["schedule"]["stages"]]
    want = sum(predicted[level] for level in stages)
    assert rec["collectives"]["all-to-all"]["result_bytes"] == want == predicted["total"]
    assert rec["predicted_hlo_wire_bytes"] == predicted
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    assert rec["memory"] is None                      # the CPU
    # The ranks issue every transpose of the grouped inter stage, and
    # record its groups: nothing is left unrecorded.
    assert "unrecorded" not in rec["collectives"]
    assert rec["collectives"]["all-reduce"]["count"] == 2      # the psums
    assert rec["collectives"]["reduce-scatter"]["count"] == 6  # 3 layers x 2


def _op(kind: str, nbytes: int, g: int, index: int = 0) -> StepOp:
    return StepOp(kind=kind, klass="collective", index=index, dtype="float32",
                  shape=(1, nbytes // 4), bytes=nbytes, chunks=g)


@pytest.mark.parametrize("g", [2, 4, 16])
def test_parse_collectives_ring_table(g):
    r = 4096
    step = LoweredStep(ops=[_op("all-to-all", r, g, 0), _op("psum_scatter", r, g, 1),
                            _op("all_gather", r, g, 2), _op("all-to-all", r, g, 3)])
    stats = parse_collectives(step)
    assert set(stats) == {"all-to-all", "reduce-scatter", "all-gather", "total",
                          "unrecorded"}
    assert stats["all-to-all"] == {"count": 2.0, "operand_bytes": 2.0 * r,
                                   "result_bytes": 2.0 * r,
                                   "wire_bytes": 2.0 * r * (g - 1) / g}
    assert stats["reduce-scatter"] == {"count": 1.0, "operand_bytes": float(r * g),
                                       "result_bytes": float(r),
                                       "wire_bytes": float(r * (g - 1))}
    assert stats["all-gather"] == {"count": 1.0, "operand_bytes": r / g,
                                   "result_bytes": float(r),
                                   "wire_bytes": r * (g - 1) / g}
    assert stats["total"]["count"] == 4.0
    assert stats["total"]["wire_bytes"] == pytest.approx(
        2 * r * (g - 1) / g + r * (g - 1) + r * (g - 1) / g)
    # A flat step (all-to-all only) has no autograd transposes to miss.
    flat = parse_collectives(LoweredStep(ops=[_op("all-to-all", r, g)]))
    assert set(flat) == {"all-to-all", "total"}


def test_wire_bytes_semantics():
    """tests/test_sharding.py::test_wire_bytes_semantics: an f32[64]
    all-gather over 16."""
    ag = parse_collectives(LoweredStep(ops=[_op("all_gather", 256, 16)]))["all-gather"]
    assert ag["operand_bytes"] == 64 * 4 / 16
    assert ag["result_bytes"] == 256
    assert ag["wire_bytes"] == pytest.approx(256 * 15 / 16)


def _plain_matmul():
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    return (lambda: a @ b), 2 * 64 * 32 * 16


def _loop_of_matmuls():
    x, w = torch.randn(128, 256), torch.randn(256, 256)

    def f():
        h = x
        for _ in range(10):
            h = torch.tanh(h @ w)
        return h
    return f, 10 * 2 * 128 * 256 * 256


def _grad_with_recompute():
    from torch.utils.checkpoint import checkpoint

    x = torch.randn(64, 128, requires_grad=True)
    w = torch.randn(128, 128, requires_grad=True)

    def g():
        h = x
        for _ in range(7):
            h = checkpoint(lambda hh: torch.tanh(hh @ w), h, use_reentrant=False)
        # jax.grad through lax.scan carries the cotangent through every
        # step, the first included; asking for x's gradient too does the
        # same here.
        torch.autograd.grad(h.sum(), (x, w))
    # fwd + recompute + 2 bwd matmuls = 4x fwd
    return g, 4 * 7 * 2 * 64 * 128 * 128


def _batched_einsum():
    a, b = torch.randn(4, 8, 16), torch.randn(4, 16, 8)
    return (lambda: torch.einsum("bik,bkj->bij", a, b)), 2 * 4 * 8 * 16 * 8


@pytest.mark.parametrize("case", [_plain_matmul, _loop_of_matmuls,
                                  _grad_with_recompute, _batched_einsum],
                         ids=["plain_matmul", "loop_multiplies_trip_count",
                              "grad_counts_fwd_recompute_bwd", "batched_einsum"])
def test_analyze_step_flops(case):
    """The expected numbers of tests/test_hlo_analysis.py's FLOP tests."""
    fn, flops = case()
    got = analyze_step(fn)
    assert got["dot_flops"] == flops
    assert got["traffic_bytes"] > 0


def test_analyze_step_skips_views():
    x = torch.randn(32, 32)
    assert analyze_step(lambda: x.view(-1, 16).t()[1:]) == {
        "dot_flops": 0.0, "traffic_bytes": 0.0}
    assert analyze_step(lambda: x + 1)["traffic_bytes"] == 2 * 32 * 32 * 4


def test_analyze_step_counts_a_kernel_call_as_one_op():
    """Each kernel wrapper reads its tensor arguments and writes its results
    once in the count, whether its kernel or its plain version runs (the
    plain version's intermediates are not counted), forward and backward."""
    from repro_torch.kernels import traffic
    from repro_torch.kernels.quant_pack import dequant_unpack, quant_pack
    from repro_torch.kernels.seg_aggregate import (DeviceBucketedEll, DeviceEllBucket,
                                                   bucketed_aggregate)

    gen = torch.Generator().manual_seed(0)
    x, u = torch.randn(8, 64, generator=gen), torch.rand(8, 64, generator=gen)
    packed, zero, scale = quant_pack(x, u, 2)
    assert packed.shape == (8, 4) and zero.shape == scale.shape == (2,)
    assert analyze_step(quant_pack, x, u, 2)["traffic_bytes"] == 2 * 2048 + 128 + 2 * 8
    assert analyze_step(dequant_unpack, packed, zero, scale, 2, 64)[
        "traffic_bytes"] == 128 + 2 * 8 + 2048

    def bucket(rows, k):
        idx = torch.randint(0, 6, (len(rows), k), generator=gen, dtype=torch.int32)
        return DeviceEllBucket(rows=torch.tensor(rows, dtype=torch.int32), idx=idx,
                               w=torch.rand(len(rows), k, generator=gen), n=len(rows))

    fwd = DeviceBucketedEll((bucket([0, 2], 3), bucket([1, 3, 4, 5], 1)))
    rev = DeviceBucketedEll((bucket([0, 1, 2, 3, 4, 5], 2),))
    h = torch.randn(6, 16, generator=gen, requires_grad=True)
    layout = traffic.tensor_bytes(fwd)
    assert layout == 2 * 4 + 2 * 3 * 8 + 4 * 4 + 4 * 1 * 8
    got = analyze_step(bucketed_aggregate, h.detach(), fwd)["traffic_bytes"]
    assert got == 2 * 6 * 16 * 4 + layout            # x read, out written
    calls = []
    with traffic.counting(calls.append):
        bucketed_aggregate(h, fwd, ell_t=rev).sum().backward()
    # the forward over fwd, and the backward over rev: g read, dx written
    assert calls == [2 * 6 * 16 * 4 + layout, 2 * 6 * 16 * 4 + traffic.tensor_bytes(rev)]


def test_check_overlap_cli(tmp_path):
    """The JAX package's ``make check-overlap`` line, on the CPU."""
    before = sorted((ROOT / "experiments" / "dryrun").glob("*"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *CHECK_OVERLAP,
         "--device", "cpu", "--out", str(tmp_path)],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "wire_before_compute=True inter_wire_before_compute=True" in proc.stdout
    rec = json.loads((tmp_path / "supergcn-graphsage__rmat10-fullbatch-g2__8chips.json")
                     .read_text())
    assert all(k in rec for k in FIELDS), [k for k in FIELDS if k not in rec]
    assert "compile_s" not in rec
    assert rec["status"] == "ok" and rec["audit_findings"] == []
    assert sorted((ROOT / "experiments" / "dryrun").glob("*")) == before


def test_lm_half_is_refused():
    """The LM half needs both --arch and --shape (or --all): an --arch alone
    is refused as the JAX package's ``main`` refuses it (argparse, exit 2)."""
    with pytest.raises(SystemExit) as e:
        tdryrun.main(["--arch", "tinyllama-1.1b", "--device", "cpu"])
    assert e.value.code == 2
