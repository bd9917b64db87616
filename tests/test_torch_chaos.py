"""Fault tolerance of the port's multiproc runtime, through the chaos
harness's own helpers (``repro_torch.launch.chaos``): a killed rank, a
stalled rank (stale heartbeat), a corrupted checkpoint, and a spent
restart budget, on the flat P=2 Int2 toy spec on the CPU. A recovered run
must equal the fault-free baseline bitwise and leave no shared-memory
segment behind.

Spawning fleets is slow, so the baseline is module-scoped.
"""

import pytest

from repro_torch.checkpoint import CheckpointManager, latest_common_step
from repro_torch.launch.chaos import (_case_plan, evaluate_case, run_baseline,
                                      run_faulted)
from repro_torch.run import RunSpec

EXACT = 0.0  # recovery reproduces the fault-free trajectory bit for bit


def _flat_ft_spec(**exec_over):
    """The P=2 flat Int2 toy spec with the fault-tolerance settings."""
    ov = dict(epochs=4, ckpt_every=1, max_restarts=2, heartbeat_s=5.0)
    ov.update(exec_over)
    return RunSpec().with_overrides([
        "graph.source=sbm", "graph.nodes=96", "graph.classes=4",
        "graph.feat_dim=16", "graph.feat_noise=2.0", "graph.homophily=0.8",
        "graph.norm=mean", "partition.nparts=2", "schedule.bits=2",
        "model.model=sage", "model.hidden_dim=16", "model.num_layers=2",
        "model.dropout=0.0", "model.label_prop=false",
        "exec.mode=multiproc", "exec.nprocs=2",
    ] + [f"exec.{k}={v}" for k, v in ov.items()])


@pytest.fixture(scope="module")
def baseline():
    return run_baseline(_flat_ft_spec(), device="cpu")


def _assert_recovered(case):
    assert case["ok"], {k: v for k, v in case.items() if k != "events"}
    assert case["restarts"] >= 1
    assert case["max_loss_delta"] == EXACT
    assert case["leaked_segments"] == []


def test_kill_resumes_trajectory_bitwise(baseline, tmp_path):
    obs = run_faulted(_flat_ft_spec(), "kill", rank=1, at_epoch=2,
                      ckpt_dir=str(tmp_path), device="cpu")
    case = evaluate_case("kill", 1, 2, baseline, obs, EXACT)
    _assert_recovered(case)
    assert case["detection_kind"] == "dead"
    assert case["restore_step"] == 2 and case["resume_epoch"] == 2
    assert case["respawn_s"] > 0 and case["restore_s"] > 0


def test_stall_resumes_trajectory_bitwise(baseline, tmp_path):
    obs = run_faulted(_flat_ft_spec(), "stall", rank=0, at_epoch=2,
                      ckpt_dir=str(tmp_path), device="cpu")
    case = evaluate_case("stall", 0, 2, baseline, obs, EXACT)
    _assert_recovered(case)
    assert case["detection_kind"] == "hung"
    # Detected from the stale heartbeat (heartbeat_s=5), long before the
    # mailbox's wait deadline.
    assert 5.0 <= case["detection_latency_s"] < 60


def test_ckpt_corruption_falls_back_one_step(baseline, tmp_path):
    obs = run_faulted(_flat_ft_spec(), "ckpt-corrupt", rank=1, at_epoch=2,
                      ckpt_dir=str(tmp_path), device="cpu")
    case = evaluate_case("ckpt-corrupt", 1, 2, baseline, obs, EXACT)
    _assert_recovered(case)
    assert case["corrupted_step"] == 2
    assert case["restore_step"] == 1


def test_restart_budget_exhaustion_aborts_clean(tmp_path):
    """max_restarts=0: the first fault ends the run with the budget error,
    no leaked segment, and the newest checkpoints left for a resume."""
    obs = run_faulted(_flat_ft_spec(max_restarts=0), "kill", rank=1, at_epoch=2,
                      ckpt_dir=str(tmp_path), device="cpu")
    assert obs["error"] is not None
    assert "restart budget exhausted" in obs["error"]
    assert obs["events"][-1]["action"] == "abort"
    assert obs["leaked_segments"] == []
    mgrs = {r: CheckpointManager(tmp_path / f"rank{r}") for r in range(2)}
    assert latest_common_step(mgrs) == 2


def test_case_plan():
    assert _case_plan("kill", 1, 2, 4) == [("kill", 1, 2)]
    assert _case_plan("all", 3, 2, 4) == [("kill", 3, 2), ("stall", 0, 3),
                                          ("ckpt-corrupt", 3, 2)]
