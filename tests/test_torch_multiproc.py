"""The port's multi-process runtime (``exec.mode="multiproc"``): per-epoch
losses and evaluation against the JAX package's vmap trainer and the
port's stacked trainer, from the same parameters and draws, the gradient
scale, the stale-epoch transport skip, shared-memory teardown (normal exit
and a killed rank leave no segment), the accounting that spawns nothing,
and the mailbox wire packing against the JAX package's.

All three runs start from the JAX package's initial parameters, and the
port's draws replay the JAX package's key folds
(``test_torch_train.JaxReplay``; every rank gets a copy). Multiproc
against vmap is a tolerance comparison (1e-5, the bar of
``tests/test_multiproc.py``): the ranks backpropagate the global mean
loss and sum their gradients in rank order, the vmap step returns ``P``
times that gradient (ROADMAP C-ref6), so AdamW's ``eps`` and the
summation order separate them. AdamW is nearly scale-invariant, so the
gradient scale is checked on its own: P times the ranks' summed gradient
norm of epoch 0 against the norm of the vmap step's gradient.

Spawning processes is slow, so each fleet is module-scoped and shared by
every assertion that can share it.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.run.session as jsession
from repro.launch import multiproc as jmp
from repro.quant.stochastic import pack_bits as j_pack_bits
from repro.run.spec import RunSpec as JRunSpec

from repro_torch.kernels.ref import dequant_unpack_ref, quant_pack_ref
from repro_torch.launch import multiproc as tmp
from repro_torch.launch.shm_store import leaked_segments
from repro_torch.parity import params_from_jax
from repro_torch.run import RunSpec, build_session

from test_torch_train import JaxReplay

TOL = 1e-5

# P=2 flat Int2: F=16 fills one packed word per row at 2 bits.
FLAT = [
    "graph.source=sbm", "graph.nodes=96", "graph.classes=4",
    "graph.feat_dim=16", "graph.feat_noise=2.0", "graph.homophily=0.8",
    "graph.norm=mean", "partition.nparts=2", "schedule.bits=2",
    "model.model=sage", "model.hidden_dim=16", "model.num_layers=2",
    "model.dropout=0.0", "model.label_prop=false",
    "exec.mode=multiproc", "exec.nprocs=2", "exec.epochs=3"]

# P=4 hierarchical 2x2, Int2 inter wire with cd=2 (epochs alternate
# refresh and stale), overlap on, dropout and label propagation on.
HIER = [
    "graph.source=sbm", "graph.nodes=128", "graph.classes=4",
    "graph.feat_dim=16", "graph.feat_noise=2.0", "graph.homophily=0.8",
    "graph.norm=mean", "partition.nparts=4", "partition.groups=2",
    "schedule.inter_bits=2", "schedule.inter_cd=2",
    "schedule.overlap=true", "schedule.agg_backend=ell",
    "model.model=sage", "model.hidden_dim=16", "model.num_layers=2",
    "model.dropout=0.5", "model.label_prop=true",
    "exec.mode=multiproc", "exec.nprocs=4", "exec.epochs=4"]

VMAP = ["exec.mode=vmap", "exec.nprocs=0"]


def _flat_spec():
    return RunSpec().with_overrides(FLAT)


def _trajectories(over, epochs):
    """Per run (``mp`` the port's multiproc, ``st`` its stacked trainer,
    ``j`` the JAX package's vmap trainer): the losses and the evaluation;
    ``j_grad_norm`` the norm of the vmap step's epoch-0 gradient and
    ``stats`` the runtime's. All on the CPU from the JAX package's initial
    parameters and its replayed draws."""
    jsess = jsession.build_session(JRunSpec().with_overrides(over + VMAP))
    tr = jsess.trainer
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, tr.params))
    jgrads = tr._unreplicate(tr._step(*tr._step_args(jax.random.PRNGKey(1000003)))[0])
    out = {"j_grad_norm": float(np.sqrt(sum(
        np.square(np.asarray(g, np.float64)).sum()
        for g in jax.tree_util.tree_leaves(jgrads))))}
    out["j"] = ([jsess.train_epoch()["loss"] for _ in range(epochs)], jsess.evaluate())

    spec = RunSpec().with_overrides(over)
    session = build_session(spec, device="cpu", params=params, randomness=JaxReplay())
    rt = session.trainer
    try:
        out["mp"] = ([session.train_epoch()["loss"] for _ in range(epochs)],
                     session.evaluate())
        out["stats"] = {"token": rt.token, "epoch_stats": list(rt.epoch_stats),
                        "summary": rt.summary()}
    finally:
        session.close()
    stacked = build_session(spec.with_overrides(VMAP), device="cpu", params=params,
                            randomness=JaxReplay())
    out["st"] = ([stacked.train_epoch()["loss"] for _ in range(epochs)],
                 stacked.evaluate())
    out["nparts"] = spec.partition.nparts
    return out


@pytest.fixture(scope="module")
def flat_run():
    return _trajectories(FLAT, epochs=3)


@pytest.fixture(scope="module")
def hier_run():
    return _trajectories(HIER, epochs=4)


def _hold(run, epochs):
    (mp_losses, mp_eval), (st_losses, st_eval), (j_losses, j_eval) = (
        run["mp"], run["st"], run["j"])
    assert len(mp_losses) == len(j_losses) == epochs
    np.testing.assert_allclose(mp_losses, j_losses, atol=TOL, rtol=0)
    np.testing.assert_allclose(mp_losses, st_losses, atol=TOL, rtol=0)
    assert mp_eval == pytest.approx(j_eval, abs=TOL)
    assert mp_eval == pytest.approx(st_eval, abs=TOL)


class TestParity:
    def test_flat_int2_losses_match_stacked(self, flat_run):
        """Against the JAX package's vmap run and the port's stacked one."""
        _hold(flat_run, 3)

    def test_hier_int2_cd2_losses_match_stacked(self, hier_run):
        """Refresh and stale epochs (cd=2 over 4 epochs serves the cached
        inter wire on epochs 1 and 3), with dropout and label propagation,
        against the JAX package's vmap run and the port's stacked one."""
        _hold(hier_run, 4)

    @pytest.mark.parametrize("run", ["flat_run", "hier_run"])
    def test_gradient_is_the_global_mean_loss_gradient(self, run, request):
        """The ranks' summed gradient is that of the global mean loss: P
        times it is the vmap step's gradient (ROADMAP C-ref6). A rank that
        seeded its backward with the wrong scale fails here, though AdamW
        would hide it from the losses."""
        r = request.getfixturevalue(run)
        norm = r["stats"]["epoch_stats"][0]["grad_norm"]
        assert norm > 0
        assert r["nparts"] * norm == pytest.approx(r["j_grad_norm"], rel=TOL)

    def test_cd2_stale_epochs_send_fewer_wire_bytes(self, hier_run):
        """A stale epoch skips the inter stage's transport: every rank's
        wire bytes alternate high (refresh) and low (stale)."""
        stats = hier_run["stats"]
        for r in range(4):
            per_epoch = [s["wire_bytes"][r] for s in stats["epoch_stats"]]
            refresh, stale = per_epoch[0], per_epoch[1]
            assert stale < refresh
            assert per_epoch == [refresh, stale, refresh, stale]

    def test_ranks_report_epoch_stats(self, hier_run):
        """Every rank reports its seconds in mailbox rounds (of them, its
        wait on peers), bytes and kernel launches (zero on the CPU, where
        the plain versions run)."""
        stats = hier_run["stats"]
        for s in stats["epoch_stats"]:
            assert len(s["wait_s"]) == len(s["wire_s"]) == len(s["launches"]) == 4
            assert all(0 <= w <= x for w, x in zip(s["wait_s"], s["wire_s"]))
            assert all(0 < x <= s["epoch_s"] for x in s["wire_s"])
            for launched in s["launches"]:
                assert set(launched) == {"seg_aggregate", "seg_aggregate_backward",
                                         "quant_pack", "dequant_unpack"}
                assert all(v == 0 for v in launched.values())

    @pytest.mark.parametrize("run,per_epoch", [("flat_run", [2, 2, 2]),
                                               ("hier_run", [4, 2, 4, 2])])
    def test_ranks_send_gathers_take_the_send_layout(self, run, per_epoch, request):
        """Every rank's plan carries the send layouts (shipped beside the
        pre-aggregation's and the receive scatter's), so on the ``ell``
        backend each of its send gathers runs over the layout and none
        through the index: one send per stage and layer, the inter stage
        on refresh epochs only."""
        stats = request.getfixturevalue(run)["stats"]["epoch_stats"]
        got = [[r["layout"] for r in s["send_gathers"]] for s in stats]
        assert got == [[n] * len(stats[0]["send_gathers"]) for n in per_epoch]
        assert all(r["index"] == 0 for s in stats for r in s["send_gathers"])

    def test_rank_rss_shows_one_shared_store_copy(self, hier_run):
        smry = hier_run["stats"]["summary"]
        assert smry["device"] == "cpu" and len(smry["ranks"]) == 4
        for r in smry["ranks"]:
            attach_delta = r["rss_after_attach"] - r["rss_before_attach"]
            assert attach_delta < max(smry["store_bytes"], 1 << 20)


class TestTeardown:
    def test_normal_exit_unlinks_all_segments(self, flat_run, hier_run):
        for run in (flat_run, hier_run):
            token = run["stats"]["token"]
            assert token is not None
            assert leaked_segments(token) == []

    def test_killed_worker_aborts_run_and_unlinks(self):
        session = build_session(_flat_spec(), device="cpu")
        rt = session.trainer
        try:
            session.train_epoch()  # spawn + one good epoch
            token = rt.token
            rt._procs[1].kill()
            with pytest.raises(RuntimeError, match="multiproc run aborted"):
                for _ in range(2):  # the next command must see the death
                    session.train_epoch()
        finally:
            session.close()
        assert leaked_segments(token) == []


class TestAccounting:
    def test_dry_plan_spawns_no_processes(self):
        session = build_session(_flat_spec(), device="cpu")
        rt = session.trainer
        try:
            assert isinstance(rt, tmp.MultiprocRuntime)
            plan = rt.dry_plan()
            assert plan["store_bytes"] > 0
            assert plan["mailbox_bytes"] > 0
            assert plan["mailbox_ops"] > 0
            assert rt._procs == [] and not rt._started and rt.token is None
            with pytest.raises(NotImplementedError):
                rt.lower_step()
        finally:
            session.close()

    def test_nprocs_must_match_nparts(self):
        spec = _flat_spec()
        with pytest.raises(Exception, match="per partition"):
            spec.with_overrides(["exec.nprocs=3"])
        # Past the spec's own check, the runtime refuses it too.
        bad = dataclasses.replace(spec, exec=dataclasses.replace(spec.exec, nprocs=3))
        from repro_torch.core.trainer import prepare_distributed_host
        from repro_torch.run.session import build_graph, build_partition
        g, x = build_graph(spec)
        hwd = prepare_distributed_host(g, x, build_partition(spec, g))
        with pytest.raises(ValueError, match="per partition"):
            tmp.MultiprocRuntime(bad, hwd, device="cpu")


class TestWirePacking:
    """The mailbox wire against the JAX package's: byte for byte where the
    width fills whole words; at a ragged width the port sends the kernel's
    ceil(F/(32/bits)) words where the JAX package sends a byte per value,
    with the same values after dequantization."""

    @pytest.mark.parametrize("bits", [2, 4, 8])
    def test_np_pack_matches_reference_and_kernel_layout(self, bits):
        rng = np.random.default_rng(bits)
        q = rng.integers(0, 1 << bits, size=(8, 32), dtype=np.int32)
        ours = tmp._np_pack(q, bits)
        np.testing.assert_array_equal(ours, jmp._np_pack(q, bits))
        np.testing.assert_array_equal(ours.view(np.int32),
                                      np.asarray(j_pack_bits(jnp.asarray(q), bits)))
        np.testing.assert_array_equal(tmp._np_unpack(ours, bits, 32), q)
        # Ragged widths: the plain packer's (and so the kernel's) layout.
        from repro_torch.quant.stochastic import pack_bits
        q = rng.integers(0, 1 << bits, size=(8, 100), dtype=np.int32)
        words = tmp._np_pack(q, bits)
        np.testing.assert_array_equal(words.view(np.int32),
                                      pack_bits(torch.from_numpy(q), bits).numpy())
        np.testing.assert_array_equal(tmp._np_unpack(words, bits, 100), q)

    @pytest.mark.parametrize("feat", [16, 100])
    def test_chunk_equals_reference(self, feat):
        """A quantized chunk packed from ``quant_pack``'s output: the
        reference's bytes where F % 16 == 0; at F = 100 (layer 0's width)
        the same values after dequantization, and the payload the port
        states (ceil(F/16) words a row, not F bytes)."""
        bits, rows = 2, 8
        rng = np.random.default_rng(feat)
        x = torch.from_numpy(rng.normal(size=(rows, feat)).astype(np.float32))
        u = torch.from_numpy(rng.uniform(size=(rows, feat)).astype(np.float32))
        words, zero, scale = quant_pack_ref(x, u, bits)
        buf = tmp._pack_chunk(words.numpy(), zero.numpy(), scale.numpy())
        assert buf.nbytes == tmp.chunk_bytes(rows, feat, bits)
        assert tmp.quant_payload_bytes(rows, feat, bits) == rows * -(-feat // 16) * 4
        q = tmp._np_unpack(words.numpy().view(np.uint32), bits, feat)
        ref = jmp._pack_chunk(q, zero.numpy(), scale.numpy(), bits)
        assert ref.nbytes == jmp.chunk_bytes(rows, feat, bits)
        if feat % 16 == 0:
            np.testing.assert_array_equal(buf, ref)
            assert tmp.chunk_bytes(rows, feat, bits) == jmp.chunk_bytes(rows, feat, bits)
        else:
            assert jmp.quant_payload_bytes(rows, feat, bits) == rows * feat
        w2, z2, s2 = tmp._unpack_chunk(buf, rows, feat, bits)
        jq, jz, js = jmp._unpack_chunk(ref, rows, feat, bits)
        np.testing.assert_array_equal(z2, jz)
        np.testing.assert_array_equal(s2, js)
        ours = dequant_unpack_ref(torch.from_numpy(w2), torch.from_numpy(z2),
                                  torch.from_numpy(s2), bits, feat).numpy()
        theirs = (jq.astype(np.float32).reshape(rows // 4, 4, feat)
                  * js[:, None, None] + jz[:, None, None]).reshape(rows, feat)
        np.testing.assert_array_equal(ours, theirs)

    def test_fp32_chunk_bytes(self):
        assert tmp.chunk_bytes(8, 16, 0) == jmp.chunk_bytes(8, 16, 0) == 8 * 16 * 4
        assert tmp.chunk_bytes(8, 100, 0) == jmp.chunk_bytes(8, 100, 0)
