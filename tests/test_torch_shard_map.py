"""The port's ``exec.mode=shard_map`` (``repro_torch.launch.spmd``): one
process per worker over gloo collectives on the CPU, against the JAX
package's ``shard_map`` trainer on the virtual devices ``conftest.py``
sets up, the port's stacked and multiproc runs, and itself resumed.

Every run starts from the JAX package's initial parameters and the port's
draws replay the JAX package's key folds (``test_torch_train.JaxReplay``),
recorded while the port's stacked run draws them
(``parity.RecordedDraws``): every rank gets a copy of the table and so
neither imports JAX nor compiles its draws. Against the JAX package the bar is 1e-5 (its
``psum`` of the gradients is P times the ranks' mean-loss gradient,
ROADMAP C-ref6, so AdamW's ``eps`` and the summation order separate
them). Against multiproc and against a resumed run the bar is bitwise:
every cross-rank sum is a data movement and then a sum in rank order.

Spawning processes is slow, so each fleet is module-scoped and shared by
every assertion that can share it; the file pins one intra-op thread.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.run.session as jsession
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.run.spec import RunSpec as JRunSpec

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.ckpt import leaves_with_keys
from repro_torch.core.trainer import prepare_distributed_host
from repro_torch.launch import spmd
from repro_torch.launch.shm_store import leaked_segments
from repro_torch.optim.adamw import tree_leaves
from repro_torch.parity import RecordedDraws, params_from_jax
from repro_torch.run import RunSpec, build_session
from repro_torch.run.session import build_graph, build_partition

from test_torch_multiproc import HIER, VMAP
from test_torch_train import ROOT, JaxReplay

TOL = 1e-5
SM = ["exec.mode=shard_map", "exec.nprocs=0"]

# (a) the specs/shard_map.json graph and model, flat P = 4, fp32, cd=3.
FLAT_EPOCHS = 5
# (b) multiproc's hierarchical 2x2 spec: Int2 inter wire, inter_cd=2,
# overlap, dropout and label propagation.
HIER_EPOCHS = 4
# (c), (d) a small flat P = 2 spec, Int2 at cd=2, for the fleets that
# need no reference.
SMALL = ["graph.source=sbm", "graph.nodes=64", "graph.classes=4", "graph.feat_dim=16",
         "graph.norm=mean", "partition.nparts=2", "schedule.bits=2", "schedule.cd=2",
         "model.model=sage", "model.hidden_dim=16", "model.num_layers=2",
         "model.dropout=0.0", "model.label_prop=false", *SM]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the test runner runs several workers side by
    side, and PyTorch's CPU thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat_spec(cls):
    return cls.load(ROOT / "specs" / "shard_map.json").with_overrides(["schedule.cd=3"])


def _np_state(tree):
    return [(k, t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t))
            for k, t in leaves_with_keys(tree)]


def _jax_params(jsess):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jsess.trainer.params))


@pytest.fixture(scope="module")
def flat_run(tmp_path_factory):
    """The flat spec: the JAX package's shard_map losses; the port's
    shard_map losses, evaluation, epoch-0 halo cache and a checkpoint at
    epoch 2; the port's stacked epoch-0 cache."""
    jsess = jsession.build_session(_flat_spec(JRunSpec))
    assert jsess.trainer.mode == "shard_map"
    params = _jax_params(jsess)
    out = {"j": [jsess.train_epoch()["loss"] for _ in range(FLAT_EPOCHS)],
           "j_eval": jsess.evaluate(), "params": params, "jsess": jsess}
    draws = RecordedDraws(JaxReplay())
    stacked = build_session(_flat_spec(RunSpec).with_overrides(["exec.mode=vmap"]),
                            device="cpu", params=params, randomness=draws)
    for e in range(FLAT_EPOCHS):
        stacked.train_epoch()
        if e == 0:
            out["st_cache0"] = [[c.numpy() for c in layer]
                                for layer in stacked.trainer._cache]
    ckpt = tmp_path_factory.mktemp("shard_map_ckpt")
    out["ckpt"] = ckpt
    session = build_session(_flat_spec(RunSpec), device="cpu", params=params,
                            randomness=draws)
    rt = session.trainer
    try:
        losses = []
        for e in range(FLAT_EPOCHS):
            losses.append(session.train_epoch()["loss"])
            if e == 0:
                out["cache0"] = [[c.numpy() for c in layer]
                                 for layer in rt.train_state()["cache"]]
            if e == 1:
                rt.save_train_state(CheckpointManager(ckpt))
        out["t"], out["t_eval"] = losses, session.evaluate()
    finally:
        session.close()
    return out


@pytest.fixture(scope="module")
def hier_run():
    """The hierarchical spec: the JAX package's shard_map on a 2x2 mesh,
    the port's shard_map and multiproc (losses, evaluation, parameters)."""
    jsess = jsession.build_session(JRunSpec().with_overrides(HIER + SM))
    assert jsess.trainer.mode == "shard_map"
    params = _jax_params(jsess)
    out = {"j": ([jsess.train_epoch()["loss"] for _ in range(HIER_EPOCHS)],
                 jsess.evaluate())}
    draws = RecordedDraws(JaxReplay())
    stacked = build_session(RunSpec().with_overrides(HIER + VMAP), device="cpu",
                            params=params, randomness=draws)
    for _ in range(HIER_EPOCHS):
        stacked.train_epoch()
    for mode in ("shard_map", "multiproc"):
        session = build_session(
            RunSpec().with_overrides(HIER + (SM if mode == "shard_map" else [])),
            device="cpu", params=params, randomness=draws)
        rt = session.trainer
        try:
            losses = [session.train_epoch()["loss"] for _ in range(HIER_EPOCHS)]
            out[mode] = (losses, session.evaluate())
            out[f"{mode}_state"] = [rep["params"] for rep in rt._command(
                {"cmd": "state"}, "state")]
            out[f"{mode}_stats"] = list(rt.epoch_stats)
            out[f"{mode}_summary"] = rt.summary()
        finally:
            session.close()
    return out


class TestAgainstJax:
    def test_flat_losses_and_eval(self, flat_run):
        """Flat P = 4 at fp32 with cd=3 (refresh epochs 0 and 3)."""
        np.testing.assert_allclose(flat_run["t"], flat_run["j"], atol=TOL, rtol=0)
        assert flat_run["t_eval"] == pytest.approx(flat_run["j_eval"], abs=TOL)

    def test_flat_epoch0_halo_cache_equals_stacked(self, flat_run):
        """Epoch 0's receive buffers, bitwise the stacked run's (the JAX
        package's own shard_map-vs-vmap check): every collective moves
        data, and the only sums are in worker order."""
        got, want = flat_run["cache0"], flat_run["st_cache0"]
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert len(a) == len(b) == 1
            np.testing.assert_array_equal(a[0], b[0])
            assert np.abs(a[0]).sum() > 0

    def test_hier_losses_and_eval(self, hier_run):
        """2x2 mesh, Int2 inter wire, inter_cd=2, overlap on."""
        (t, t_eval), (j, j_eval) = hier_run["shard_map"], hier_run["j"]
        np.testing.assert_allclose(t, j, atol=TOL, rtol=0)
        assert t_eval == pytest.approx(j_eval, abs=TOL)

    def test_checkpoint_restores_into_the_jax_package(self, flat_run):
        """The port's shard_map checkpoint is the JAX package's npz format:
        its shard_map trainer restores it (replicated parameters and AdamW
        state, the cache over the worker axis) and trains the next epoch
        to the port's loss."""
        jsess = flat_run["jsess"]
        tr = jsess.trainer
        assert tr.restore_train_state_from(JCheckpointManager(flat_run["ckpt"])) == 2
        assert tr.epoch == 2
        assert jsess.train_epoch()["loss"] == pytest.approx(flat_run["t"][2], abs=TOL)


class TestAgainstMultiproc:
    def test_losses_eval_and_parameters_bitwise(self, hier_run):
        assert hier_run["shard_map"] == hier_run["multiproc"]
        for sm, mp in zip(hier_run["shard_map_state"], hier_run["multiproc_state"]):
            for a, b in zip(tree_leaves(sm), tree_leaves(mp)):
                np.testing.assert_array_equal(a, b)

    def test_parameters_replicated(self, hier_run):
        ranks = hier_run["shard_map_state"]
        assert len(ranks) == 4
        for other in ranks[1:]:
            for a, b in zip(tree_leaves(other), tree_leaves(ranks[0])):
                np.testing.assert_array_equal(a, b)

    def test_wire_bytes_match_multiproc_and_skip_stale_epochs(self, hier_run):
        """Per rank, the collectives deliver the bytes the mailboxes move;
        a stale epoch skips the inter stage."""
        sm, mp = hier_run["shard_map_stats"], hier_run["multiproc_stats"]
        for r in range(4):
            per_epoch = [s["wire_bytes"][r] for s in sm]
            assert per_epoch == [s["wire_bytes"][r] for s in mp]
            refresh, stale = per_epoch[0], per_epoch[1]
            assert stale < refresh and per_epoch == [refresh, stale, refresh, stale]

    def test_send_gathers_take_the_send_layout_as_multiproc(self, hier_run):
        """The ranks build their plans as multiproc's do, send layouts
        included: every send gather runs over the layout, as many as
        multiproc's ranks run, so the two keep one backward."""
        got = [s["send_gathers"] for s in hier_run["shard_map_stats"]]
        assert got == [s["send_gathers"] for s in hier_run["multiproc_stats"]]
        assert all(r["layout"] > 0 and r["index"] == 0 for s in got for r in s)

    def test_lowered_bytes_equal_a_real_ranks_wire_bytes(self, hier_run):
        """``Session.lower()`` records, per rank, what the rank's collectives
        deliver in a refresh epoch (``LoweredStep.wire_bytes``: every
        recorded collective, an all_gather's copies counted as
        ``CollectiveWire`` counts them) — the gloo rank's own count."""
        with build_session(RunSpec().with_overrides(HIER + SM), device="cpu") as s:
            progs = s.lower(epoch=0).programs
        real = hier_run["shard_map_stats"][0]["wire_bytes"]
        assert [p.wire_bytes() for p in progs] == real

    def test_ranks_report_epoch_stats(self, hier_run):
        """wait_s within wire_s within the epoch; no launches on the CPU."""
        for s in hier_run["shard_map_stats"]:
            assert len(s["wait_s"]) == len(s["wire_s"]) == len(s["launches"]) == 4
            assert all(0 <= w <= x <= s["epoch_s"] for w, x in zip(s["wait_s"], s["wire_s"]))
            for launched in s["launches"]:
                assert set(launched) == {"seg_aggregate", "seg_aggregate_backward",
                                         "quant_pack", "dequant_unpack"}
                assert all(v == 0 for v in launched.values())
        smry = hier_run["shard_map_summary"]
        assert smry["backend"] == "gloo" and smry["devices"] == ["cpu"] * 4
        assert smry["mesh"] == {"group": 2, "node": 2}
        assert [r["rank"] for r in smry["ranks"]] == [0, 1, 2, 3]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Two sessions of one spec, both fleets up at once. ``a`` trains two
    epochs with a checkpoint each, then a third; ``b`` trains its first
    epoch, resumes from ``a``'s epoch-2 checkpoint (``fit(resume=True)``)
    and trains the third; then one of ``b``'s ranks is killed."""
    spec = RunSpec().with_overrides(SMALL)
    ckpt = str(tmp_path_factory.mktemp("pair_ckpt"))
    a, b = build_session(spec, device="cpu"), build_session(spec, device="cpu")
    out = {}
    try:
        a.trainer._ensure_started()
        b.trainer._ensure_started()
        out["rendezvous"] = (a.trainer._rendezvous, b.trainer._rendezvous)
        out["a"] = [m["loss"] for m in a.fit(2, log_every=1, ckpt_dir=ckpt)]
        out["b0"] = b.train_epoch()["loss"]
        out["a3"] = a.fit(3, log_every=1)
        out["a_state"] = _np_state(a.trainer.train_state())
        out["b3"] = b.fit(3, log_every=1, ckpt_dir=ckpt, resume=True)
        out["b_state"] = _np_state(b.trainer.train_state())
        rt = b.trainer
        out["b_token"], out["b_rendezvous"] = rt.token, rt._rendezvous
        rt._procs[1].kill()
        with pytest.raises(RuntimeError, match="shard_map run aborted") as err:
            for _ in range(2):  # the next command must see the death
                b.train_epoch()
        out["abort"] = str(err.value)
        out["b_after"] = (rt._procs, rt._rendezvous)
    finally:
        a.close()
        b.close()
    return out


class TestResume:
    def test_resumed_run_is_bitwise(self, pair):
        """Two epochs with a checkpoint each (``Session.fit(ckpt_dir=...)``),
        then another session resumed from epoch 2 for one more epoch: the
        uninterrupted third epoch's loss, evaluation and state, bitwise,
        with the replicated state equal on every rank (``train_state``
        checks) and the delayed stage's halo cache restored on each."""
        full, tail = pair["a3"], pair["b3"]
        assert [m["epoch"] for m in full] == [m["epoch"] for m in tail] == [3]
        assert tail[0]["loss"] == full[0]["loss"]
        assert tail[0]["eval_acc"] == full[0]["eval_acc"]
        got, want = pair["b_state"], pair["a_state"]
        assert [k for k, _ in got] == [k for k, _ in want]
        assert any(k.startswith("['cache']") for k, _ in got)
        for (_, x), (_, y) in zip(got, want):
            np.testing.assert_array_equal(x, y)


class TestRuntime:
    def test_two_sessions_at_once_do_not_collide(self, pair):
        """Two fleets rendezvous side by side (a FileStore each) and train
        the same spec to the same first loss."""
        ra, rb = pair["rendezvous"]
        assert ra != rb
        assert pair["b0"] == pair["a"][0]

    def test_failed_rank_stops_the_run_and_cleans_up(self, pair):
        """No respawn: a killed rank stops the run, every rank is stopped,
        the store unlinked and the rendezvous directory removed."""
        import os

        assert "ranks [" in pair["abort"]
        assert pair["b_after"] == ([], None)
        assert leaked_segments(pair["b_token"]) == []
        assert not os.path.exists(pair["b_rendezvous"])

    def test_nccl_needs_a_card_per_rank(self, monkeypatch):
        """NCCL runs rank r on cuda:r: more ranks than visible cards raise,
        naming both counts, when the fleet is to start (lowering starts
        none, so the runtime builds); NCCL on the CPU and unknown backends
        raise."""
        spec = RunSpec().with_overrides(SMALL + ["partition.nparts=4"])
        g, x = build_graph(spec)
        hwd = prepare_distributed_host(g, x, build_partition(spec, g))
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        rt = spmd.ShardMapRuntime(spec, hwd, device="cuda")
        with pytest.raises(RuntimeError, match="4 ranks .* need 4 visible cards, 2 are"):
            rt._ensure_started()
        assert not rt._started and rt._procs == []
        with pytest.raises(ValueError, match="needs a CUDA device"):
            spmd.ShardMapRuntime(spec, hwd, device="cpu", backend="nccl")
        with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
            spmd.ShardMapRuntime(spec, hwd, device="cpu", backend="mpi")
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        assert spmd.resolve_backend(torch.device("cuda"), None, 4) == (
            "nccl", ["cuda:0", "cuda:1", "cuda:2", "cuda:3"])
        assert spmd.resolve_backend(torch.device("cuda"), "gloo", 2) == (
            "gloo", ["cuda:0", "cuda:0"])
        bad = dataclasses.replace(spec, exec=dataclasses.replace(spec.exec, nprocs=3))
        with pytest.raises(ValueError, match="per partition"):
            spmd.ShardMapRuntime(bad, hwd, device="cpu")

    def test_launch_train_cli(self):
        """``python -m repro_torch.launch.train --set exec.mode=shard_map``
        trains, and says over which backend."""
        import io
        from contextlib import redirect_stdout

        from repro_torch.launch import train as tlaunch

        out = io.StringIO()
        with redirect_stdout(out):
            rc = tlaunch.main(["--spec", str(ROOT / "specs" / "multiproc_p4.json"),
                               "--set", "exec.mode=shard_map", "--set", "exec.nprocs=0",
                               "--set", "partition.nparts=2", "--set", "exec.epochs=1",
                               "--device", "cpu"])
        text = out.getvalue()
        assert rc == 0
        assert "2 workers in 2 processes over gloo on cpu" in text
        assert "trained 1 epochs" in text and "shard_map: 2 procs" in text

    def test_backend_is_only_for_shard_map(self):
        with pytest.raises(ValueError, match="is for exec.mode=shard_map"):
            build_session(RunSpec().with_overrides(SMALL + ["exec.mode=vmap"]),
                          device="cpu", backend="gloo")

    def test_lower_step_raises(self, monkeypatch):
        """Lowering opens a world of its own: inside another it raises, and
        so do ranks whose programs differ (``check_one_program``). Neither
        building nor lowering spawns anything."""
        import torch.distributed as dist

        with build_session(RunSpec().with_overrides(SMALL), device="cpu") as s:
            progs = s.lower().programs
            with monkeypatch.context() as m:
                m.setattr(dist, "is_initialized", lambda: True)
                with pytest.raises(RuntimeError, match="already in one"):
                    s.lower()
            bad = dataclasses.replace(progs[1], ops=[
                dataclasses.replace(o, group=(1,)) if o.kind == "psum" else o
                for o in progs[1].ops])
            with pytest.raises(RuntimeError, match="rank 1's op 0 differs from rank 0's"):
                spmd.check_one_program([progs[0], bad])
            assert not s.trainer._started   # building spawns nothing


class TestMeshGroups:
    @pytest.mark.parametrize("sizes", [(4,), (2, 2), (1, 4), (2, 3)])
    def test_groups_of_one_process(self, sizes, monkeypatch):
        """Each axis's group is the ranks that differ from this one along
        that axis alone; every rank creates every group in one order."""
        import torch.distributed as dist

        from repro_torch.launch.mesh import Mesh, mesh_groups

        made, first = [], None
        world = int(np.prod(sizes))
        monkeypatch.setattr(dist, "get_world_size", lambda group=None: world)
        monkeypatch.setattr(dist, "new_group", lambda ranks: made.append(ranks) or tuple(ranks))
        names = ("group", "node")[-len(sizes):] if len(sizes) == 2 else ("workers",)
        mesh = Mesh(names, sizes)
        for rank in range(world):
            made.clear()
            groups = mesh_groups(mesh, rank)
            if len(sizes) == 1:
                assert groups == {"workers": dist.group.WORLD} and made == []
                continue
            g, w = divmod(rank, sizes[1])
            want_node = tuple(g * sizes[1] + v for v in range(sizes[1]))
            want_group = tuple(b * sizes[1] + w for b in range(sizes[0]))
            assert groups["group"] == (dist.group.WORLD if sizes[0] == world
                                       else want_group)
            assert groups["node"] == (dist.group.WORLD if sizes[1] == world
                                      else want_node)
            assert len(made) == ((sizes[0] < world) * sizes[1]
                                 + (sizes[1] < world) * sizes[0])
            first = list(made) if first is None else first
            assert made == first
