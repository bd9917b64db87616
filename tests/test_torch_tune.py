"""The port's sweep, tuner, ``exec.auto`` and CLI layer against the JAX
package's (``repro.run.{sweep,tune,cli,session}``), on the checked-in
specs (256 nodes) on the CPU.

Host-side rows are compared exactly: both packages build the same
partitions with the same numpy and model them with the same perf model.
Training comparisons are port against port, bitwise, under
``torch.use_deterministic_algorithms`` (the CPU's multi-threaded index
backward otherwise adds in a varying order)."""

import argparse
import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.run.cli as jcli
import repro.run.session as jsession
import repro.run.sweep as jsweep
from repro.run.spec import RunSpec as JRunSpec
from repro.run.spec import SpecError as JSpecError

import repro_torch.launch.train as tlaunch
import repro_torch.run.cli as tcli
import repro_torch.run.sweep as tsweep
from repro_torch.run import RunSpec, SpecError, build_session, resolve_auto
from repro_torch.run.session import BuildCache

# Both run packages export a ``tune`` function, which hides the module of
# that name from ``import ... as``.
jtune = importlib.import_module("repro.run.tune")
ttune = importlib.import_module("repro_torch.run.tune")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
SPECS = ROOT / "specs"
HIER = SPECS / "hier_int2_inter.json"

ROW_KEYS = ("spec_hash", "overrides", "partition_stats", "stage_rows",
            "predicted_wire_bytes", "overlap", "modelled", "modelled_epoch_s")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the test runner runs several workers side by
    side, and PyTorch's CPU thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


@pytest.mark.parametrize("rel", ["run/cli.py", "run/sweep.py"])
def test_copies_are_verbatim(rel):
    orig = (SRC / "repro" / rel).read_text()
    port = (SRC / "repro_torch" / rel).read_text()
    assert port == orig.replace("repro.", "repro_torch.")


@pytest.mark.parametrize("axis", ["schedule.inter_bits=0,2,null",
                                  "partition.refine=none,bucket-max",
                                  "schedule.overlap=true,false",
                                  "exec.lr=0.01,1e-3"])
def test_parse_axis_equal(axis):
    assert tsweep.parse_axis(axis) == jsweep.parse_axis(axis)


def test_parse_axis_refuses_like_the_reference():
    with pytest.raises(JSpecError):
        jsweep.parse_axis("no-equals-sign")
    with pytest.raises(SpecError):
        tsweep.parse_axis("no-equals-sign")


def test_product_overrides_equal():
    axes = ["partition.refine=none,bucket-max", "schedule.inter_bits=0,2",
            "schedule.inter_cd=1,2", 'c.d="x"']
    assert tsweep.product_overrides(axes) == jsweep.product_overrides(axes)


def _rows(rows):
    return [{k: r[k] for k in ROW_KEYS} for r in rows]


def test_sweep_rows_equal_the_reference():
    sets = tsweep.product_overrides(["partition.refine=none,bucket-max",
                                     "schedule.inter_bits=0,2",
                                     "schedule.overlap=true,false"])
    # The first resolves to the spec as loaded, the second is not a refine
    # mode the schema knows, the third a stage override of a flat spec.
    sets += [[], ["partition.refine=magic"],
             ["partition.groups=0", "schedule.inter_bits=2"]]
    jrows, jinvalid = jsweep.sweep_rows(JRunSpec.load(HIER), sets)
    cache = BuildCache()
    trows, tinvalid = tsweep.sweep_rows(RunSpec.load(HIER), sets, cache=cache)
    assert _rows(trows) == _rows(jrows)
    assert [r.get("aliases") for r in trows] == [r.get("aliases") for r in jrows]
    assert [r["spec"] for r in trows] == [r["spec"] for r in jrows]
    assert tinvalid == jinvalid and len(tinvalid) == 2
    # schedule-only variants share the graph and the two partitions
    assert len(cache.graphs) == 1 and len(cache.partitions) == 2


def test_modelled_only_tune_equals_the_reference():
    axes = ["partition.refine=none,bucket-max", "schedule.inter_bits=0,2",
            "schedule.inter_cd=1,2"]
    j = jtune.tune(JRunSpec.load(HIER), axes=axes, top_k=2, probe_mode="none",
                   audit=False)
    t = ttune.tune(RunSpec.load(HIER), axes=axes, top_k=2, probe_mode="none",
                   audit=False, device="cpu")
    assert _rows(t["rows"]) == _rows(j["rows"])
    assert t["invalid"] == j["invalid"]
    assert [c["spec_hash"] for c in t["shortlist"]] == \
        [c["spec_hash"] for c in j["shortlist"]]
    assert t["winner"]["spec"] == j["winner"]["spec"]
    assert t["winner"]["spec_hash"] == j["winner"]["spec_hash"]
    assert t["base"] == j["base"] and t["hw"] == j["hw"]


def _jax_tuned_file(tmp_path, axes=("partition.refine=none,bucket-max",
                                    "schedule.inter_cd=1,2")):
    result = jtune.tune(JRunSpec.load(HIER), axes=list(axes), top_k=1,
                        probe_mode="none", audit=False)
    path = tmp_path / "tuned_by_jax.json"
    path.write_text(json.dumps(result))
    return str(path), result


def test_resolve_auto_reads_a_jax_tuner_file(tmp_path):
    path, result = _jax_tuned_file(tmp_path)
    tspec = RunSpec.load(HIER).with_overrides([f"exec.auto={path}"])
    jspec = JRunSpec.load(HIER).with_overrides([f"exec.auto={path}"])
    got, want = resolve_auto(tspec), jsession.resolve_auto(jspec)
    assert got.to_dict() == want.to_dict()
    assert got.content_hash() == want.content_hash()
    tuned = RunSpec.from_dict(result["winner"]["spec"])
    assert got.partition == tuned.partition and got.schedule == tuned.schedule
    assert got.graph == tspec.graph and got.exec.auto == path


def test_resolve_auto_refusals(tmp_path):
    path, _ = _jax_tuned_file(tmp_path)
    base = RunSpec.load(HIER)
    with pytest.raises(SpecError, match="graph"):
        resolve_auto(base.with_overrides(["graph.nodes=300", f"exec.auto={path}"]))
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"rows": []}))
    with pytest.raises(SpecError, match="winner"):
        resolve_auto(base.with_overrides([f"exec.auto={empty}"]))
    with pytest.raises(SpecError, match="cannot read"):
        resolve_auto(base.with_overrides([f"exec.auto={tmp_path}/nope.json"]))
    assert resolve_auto(base) is base


def _train(spec, epochs=2):
    sess = build_session(spec, device="cpu")
    losses = [sess.train_epoch()["loss"] for _ in range(epochs)]
    return sess, losses


def test_exec_auto_session_trains_as_the_explicit_winner(tmp_path, deterministic):
    path, result = _jax_tuned_file(tmp_path)
    base = RunSpec.load(HIER)
    auto, la = _train(base.with_overrides([f"exec.auto={path}"]))
    winner = RunSpec.from_dict(result["winner"]["spec"])
    explicit, le = _train(winner)
    assert la == le
    assert auto.schedule == explicit.schedule
    for a, b in zip(auto.trainer.params["layers"], explicit.trainer.params["layers"]):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def _parser():
    ap = argparse.ArgumentParser()
    tcli.add_spec_args(ap)
    tlaunch.add_legacy_args(ap)
    return ap


ARGVS = [
    [],
    ["--nparts", "8", "--groups", "2", "--inter-bits", "2", "--epochs", "30"],
    ["--spec", str(HIER), "--set", "exec.epochs=100", "--set", "schedule.inter_cd=4"],
    ["--spec", str(HIER), "--inter-cd", "3", "--set", "schedule.inter_cd=4"],
    ["--seed", "7", "--no-lp", "--no-overlap", "--agg-backend", "coo",
     "--feat-dim", "12", "--hidden", "24", "--degree", "6.5", "--lr", "0.003"],
    ["--mode", "multiproc", "--nparts", "4", "--nprocs", "4", "--ckpt-every", "2",
     "--max-restarts", "1", "--heartbeat-s", "3.5", "--model", "gcn",
     "--strategy", "pre", "--bits", "4", "--cd", "2"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_spec_from_args_hashes_equal_the_reference(argv):
    args = _parser().parse_args(argv)
    assert tcli.legacy_overrides(args) == jcli.legacy_overrides(args)
    assert tcli.spec_from_args(args).content_hash() == \
        jcli.spec_from_args(args).content_hash()


def test_invalid_flags_exit_like_the_reference():
    args = _parser().parse_args(["--nparts", "8", "--mode", "multiproc", "--nprocs", "4"])
    with pytest.raises(SystemExit, match="invalid run configuration") as t:
        tcli.spec_from_args(args)
    with pytest.raises(SystemExit, match="invalid run configuration") as j:
        jcli.spec_from_args(args)
    assert str(t.value) == str(j.value)


def test_legacy_flags_cover_every_alias():
    dests = {a.dest for a in _parser()._actions}
    assert set(tcli.LEGACY_ALIASES) - dests == {"scale"}   # as the JAX launcher


def test_launcher_takes_legacy_flags_and_exec_auto(tmp_path, capsys):
    path, result = _jax_tuned_file(tmp_path)
    rc = tlaunch.main(["--spec", str(HIER), "--epochs", "1", "--inter-cd", "3",
                       "--set", f"exec.auto={path}", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "trained 1 epochs" in out
    # exec.auto's winner replaces the schedule section the --inter-cd alias set.
    winner = RunSpec.from_dict(result["winner"]["spec"])
    sched = winner.schedule.to_dist_config(winner.partition).schedule()
    assert f"exchange schedule: {sched.describe()}" in out


class _StubSession:
    """Epochs that alternate in cost on a fake clock: 1 s, then 3 s."""

    def __init__(self, clock):
        self.clock = clock
        self.epochs = 0
        self.closed = False

    def train_epoch(self):
        self.clock[0] += 1.0 if self.epochs % 2 == 0 else 3.0
        self.epochs += 1
        return {"loss": 0.0}

    def close(self):
        self.closed = True


@pytest.fixture
def stub_clock(monkeypatch):
    clock = [0.0]
    made = []

    def fake_build(spec, device="cuda", cache=None):
        made.append(_StubSession(clock))
        return made[-1]

    monkeypatch.setattr(ttune, "build_session", fake_build)
    monkeypatch.setattr(ttune.time, "perf_counter", lambda: clock[0])
    return made


def test_probe_times_whole_periods(stub_clock):
    cd2 = RunSpec.load(HIER).with_overrides(["schedule.inter_cd=2"])
    assert ttune.schedule_period(cd2) == 2
    r = ttune.measure_epoch_s(cd2, epochs=3, warmup=1, device="cpu")
    # warm-up epoch 0 costs 1 s; then 4 timed epochs: 3, 1, 3, 1
    assert r["epochs_s"] == [3.0, 1.0, 3.0, 1.0] and r["period"] == 2
    assert r["epoch_s"] == 2.0           # each period's mean, not a stale epoch
    assert stub_clock[0].closed


def test_interleaved_probes_time_whole_periods(stub_clock):
    base = RunSpec.load(HIER)
    specs = {"cd1": base.with_overrides(["schedule.inter_cd=1"]),
             "cd2": base.with_overrides(["schedule.inter_cd=2"])}
    r = ttune.measure_probes(specs, "vmap", epochs=3, warmup=0, device="cpu")
    assert r["cd1"]["period"] == 1 and len(r["cd1"]["epochs_s"]) == 3
    assert r["cd2"]["period"] == 2 and r["cd2"]["epochs_s"] == [1.0, 3.0] * 2
    assert r["cd2"]["epoch_s"] == 2.0 and r["cd2"]["interleaved"]
    assert all(s.closed for s in stub_clock)


def test_period_epoch_s_is_the_median_of_period_means():
    assert ttune.period_epoch_s([1.0, 3.0, 1.0, 5.0, 2.0, 2.0], 2) == 2.0
    assert ttune.period_epoch_s([4.0, 1.0, 2.0], 1) == 2.0


def test_audited_vmap_tune_on_cpu():
    """The closed loop on the CPU: sweep, the auditor's gate on every
    shortlisted candidate, interleaved stacked probes, the winner."""
    r = ttune.tune(RunSpec.load(HIER), axes=["schedule.inter_cd=2"], top_k=2,
                   probe_mode="vmap", audit_steps=2, device="cpu")
    assert len(r["shortlist"]) == 2 and not r["rejected"]
    for c in r["shortlist"]:
        assert c["audit"]["clean"] and len(c["audit"]["ran"]) == 5
        assert c["probe"]["interleaved"] and c["measured_epoch_s"] > 0
    periods = sorted(c["probe"]["period"] for c in r["shortlist"])
    assert periods == [1, 2]
    assert r["winner"]["spec_hash"] in {c["spec_hash"] for c in r["shortlist"]}
    assert r["calibration"] > 0


def test_multiproc_probe_tune_on_cpu():
    base = RunSpec.load(SPECS / "multiproc_p4.json")
    r = ttune.tune(base, axes=["schedule.inter_cd=1,2"], top_k=1,
                   probe_mode="multiproc", device="cpu")
    w = r["winner"]
    assert w["audit"]["clean"] and len(w["audit"]["ran"]) == 5
    probe = w["probe"]
    assert len(probe["epochs_s"]) % probe["period"] == 0
    assert "interleaved" not in probe and w["measured_epoch_s"] > 0


def test_sweep_and_tune_clis(tmp_path, capsys):
    sweep_out, tune_out = tmp_path / "sweep.json", tmp_path / "tuned.json"
    tsweep.main(["--spec", str(HIER), "--axis", "schedule.inter_cd=1,2",
                 "--no-spec", "--out", str(sweep_out)])
    rows = json.loads(sweep_out.read_text())["rows"]
    assert len(rows) == 2 and all("spec" not in r for r in rows)
    ttune.main(["--spec", str(HIER), "--axis", "schedule.inter_cd=1,2",
                "--probe-mode", "none", "--no-audit", "--device", "cpu",
                "--out", str(tune_out)])
    result = json.loads(tune_out.read_text())
    assert result["winner"]["spec"] and result["tuner"]["device"] == "cpu"
    assert "exec.auto=" in capsys.readouterr().err
