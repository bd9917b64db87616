"""The port's checkpoints: the JAX package's format, read in both directions.

* The JAX package's checkpoint semantics (``tests/test_fault_tolerance.py``,
  ``tests/test_data_checkpoint.py``) run against the port's copy: round
  trip, shape mismatch, retention, corrupt newest falls back, a stale
  manifest or a missing one refused, ``latest_common_step``.
* The flagship spec's training state (hierarchical 2x4, Int2 inter wire
  with ``inter_cd=2``, so the halo cache is part of it) flattens to the
  same key strings, shapes and dtypes as ``jax.tree_util.keystr`` gives
  the JAX trainer's.
* A checkpoint written by either package restores into the other's
  trainer and evaluates the same (within 1e-5), and the JAX server
  serves a port checkpoint with the port server's logits (within 1e-5).
* In the port, a run resumed from a checkpoint equals the uninterrupted
  run bit for bit; ``serve.ckpt`` serves the trained parameters.
"""

import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.run.session as jsession
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint.ckpt import _flatten as j_flatten
from repro.run.spec import RunSpec as JRunSpec
from repro.serve import ServeSpec as JServeSpec
from repro.serve import build_server as j_build_server

from repro_torch.checkpoint import (CheckpointCorrupt, CheckpointManager,
                                    latest_common_step, load_checkpoint,
                                    restore_train_state, save_checkpoint)
from repro_torch.checkpoint.ckpt import _flatten
from repro_torch.launch import train as tlaunch
from repro_torch.optim.adamw import AdamWState, tree_leaves
from repro_torch.parity import params_from_jax
from repro_torch.run import RunSpec, build_session
from repro_torch.serve import ServeError, ServeSpec, build_server

ROOT = Path(__file__).resolve().parents[1]
FLAGSHIP = ROOT / "specs" / "flagship_hier_int2_overlap.json"
VMAP = ["exec.mode=vmap"]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the test runner runs several workers side by
    side, and PyTorch's CPU thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(v=0.0):
    return {"layers": [{"w": torch.full((2, 3), 1.5 + v), "b": torch.zeros(3)}],
            "step": 7}


# -- the JAX package's checkpoint semantics, on the port's copy ---------------


def test_roundtrip(tmp_path):
    tree = {"layers": [{"w": torch.arange(6.0).reshape(2, 3), "b": torch.zeros(3)}],
            "opt": AdamWState(step=5, mu=[torch.ones(2)], nu=[torch.zeros(2)])}
    p = save_checkpoint(tmp_path / "ck", tree, step=5, meta={"note": "t"})
    assert p.exists()
    template = {"layers": [{"w": torch.zeros(2, 3), "b": torch.ones(3)}],
                "opt": AdamWState(step=0, mu=[torch.zeros(2)], nu=[torch.ones(2)])}
    restored, manifest = restore_train_state(tmp_path / "ck", template)
    assert manifest["step"] == 5 and manifest["meta"] == {"note": "t"}
    assert torch.equal(restored["layers"][0]["w"], torch.arange(6.0).reshape(2, 3))
    assert isinstance(restored["opt"], AdamWState) and restored["opt"].step == 5
    assert type(restored["opt"].step) is int
    assert torch.equal(restored["opt"].mu[0], torch.ones(2))
    assert sorted(load_checkpoint(tmp_path / "ck")["arrays"]) == [
        "['layers'][0]['b']", "['layers'][0]['w']", "['opt'].mu[0]",
        "['opt'].nu[0]", "['opt'].step"]


def test_shape_mismatch_raises(tmp_path):
    save_checkpoint(tmp_path / "ck", {"w": torch.zeros(2, 2)})
    with pytest.raises(ValueError):
        restore_train_state(tmp_path / "ck", {"w": torch.zeros(3, 2)})
    with pytest.raises(KeyError):
        restore_train_state(tmp_path / "ck", {"v": torch.zeros(2, 2)})


def test_retention_keeps_newest_k(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in range(1, 5):
        mgr.save(_tree(s), step=s, meta={"epoch": s})
    assert mgr.steps() == [3, 4]
    assert mgr.latest() == 4
    ck, step = mgr.load_latest()
    assert step == 4
    assert ck["manifest"]["meta"]["epoch"] == 4


def test_corrupt_newest_falls_back_to_previous(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(_tree(1), step=1)
    mgr.save(_tree(2), step=2)
    npz = mgr.path_for(2).with_suffix(".npz")
    raw = bytearray(npz.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    npz.write_bytes(bytes(raw))
    assert not mgr.verify(2)
    assert mgr.valid_steps() == [1]
    _, step = mgr.load_latest()
    assert step == 1
    with pytest.raises(CheckpointCorrupt):
        load_checkpoint(mgr.path_for(2))


def test_stale_manifest_beside_new_arrays_rejected(tmp_path):
    p = tmp_path / "ck"
    save_checkpoint(p, _tree(0.0), step=1)
    other = tmp_path / "other"
    save_checkpoint(other, _tree(9.0), step=1)
    p.with_suffix(".npz").write_bytes(other.with_suffix(".npz").read_bytes())
    with pytest.raises(CheckpointCorrupt, match="checksum mismatch"):
        load_checkpoint(p)
    assert load_checkpoint(p, verify=False)["arrays"]


def test_missing_manifest_never_committed(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(_tree(), step=1)
    mgr.path_for(1).with_suffix(".json").unlink()
    assert mgr.steps() == []
    with pytest.raises(FileNotFoundError):
        load_checkpoint(mgr.path_for(1))


def test_latest_common_step_across_ranks(tmp_path):
    mgrs = {r: CheckpointManager(tmp_path / f"rank{r}") for r in range(2)}
    for s in (1, 2, 3):
        mgrs[0].save(_tree(s), step=s)
    for s in (1, 2):
        mgrs[1].save(_tree(s), step=s)
    assert latest_common_step(mgrs) == 2
    mgrs[1].delete(2)
    assert latest_common_step(mgrs) == 1
    mgrs[1].delete(1)
    assert latest_common_step(mgrs) is None


# -- the training state, key for key ------------------------------------------


@pytest.fixture(scope="module")
def sessions():
    """A JAX and a port session of the flagship spec (vmap), from the same
    initial parameters."""
    js = jsession.build_session(JRunSpec.load(FLAGSHIP).with_overrides(VMAP))
    ts = build_session(RunSpec.load(FLAGSHIP).with_overrides(VMAP), device="cpu",
                       params=params_from_jax(jax.tree_util.tree_map(
                           np.asarray, js.trainer.params)))
    return js, ts


def test_train_state_keys_match_keystr(sessions):
    js, ts = sessions
    want = j_flatten(js.trainer.train_state())
    got = _flatten(ts.trainer.train_state())
    assert sorted(got) == sorted(want)
    assert "['opt_state'].step" in got and "['cache'][1][0]" in got
    assert "['opt_state'].mu['layers'][1]['b']" in got
    for k, a in want.items():
        assert got[k].shape == a.shape and got[k].dtype == a.dtype, k
    assert got["['opt_state'].step"].dtype == np.int32
    assert got["['cache'][0][0]"].shape[:2] == (2, 4)     # [G, W, rows, F]


def _train_and_save(session, manager, epochs=2):
    for _ in range(epochs):
        session.train_epoch()
    session.trainer.save_train_state(manager)


def _same_state(a, b) -> bool:
    fa, fb = _flatten(a), _flatten(b)
    return sorted(fa) == sorted(fb) and all(np.array_equal(fa[k], fb[k]) for k in fa)


def test_port_checkpoint_restores_in_jax(tmp_path):
    ts = build_session(RunSpec.load(FLAGSHIP).with_overrides(VMAP), device="cpu")
    _train_and_save(ts, CheckpointManager(tmp_path))
    js = jsession.build_session(JRunSpec.load(FLAGSHIP).with_overrides(VMAP))
    assert js.trainer.restore_train_state_from(JCheckpointManager(tmp_path)) == 2
    assert js.trainer.epoch == ts.trainer.epoch == 2
    np.testing.assert_allclose(js.evaluate(), ts.evaluate(), **TOL)
    jf, tf = j_flatten(js.trainer.params), _flatten(ts.trainer.params)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        np.testing.assert_array_equal(jf[k], tf[k], err_msg=k)


def test_jax_checkpoint_restores_in_port(tmp_path):
    js = jsession.build_session(JRunSpec.load(FLAGSHIP).with_overrides(VMAP))
    _train_and_save(js, JCheckpointManager(tmp_path))
    ts = build_session(RunSpec.load(FLAGSHIP).with_overrides(VMAP), device="cpu")
    assert ts.trainer.restore_train_state_from(CheckpointManager(tmp_path)) == 2
    assert ts.trainer.epoch == 2 and ts.trainer.opt_state.step == 2
    np.testing.assert_allclose(ts.evaluate(), js.evaluate(), **TOL)
    jc = js.trainer.train_state()["cache"]
    for jl, tl in zip(jc, ts.trainer._cache):
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(np.asarray(a).reshape(b.shape), b.numpy())


# -- resume and serve, in the port --------------------------------------------


def _spec(epochs):
    return RunSpec.load(FLAGSHIP).with_overrides(VMAP + [f"exec.epochs={epochs}"])


@pytest.fixture
def deterministic():
    """PyTorch's deterministic algorithms for one test. On the CPU the
    backward of advanced indexing (``index_put_`` with accumulate) adds in
    parallel with atomics, so two identical multi-threaded runs can differ
    in the last bit; deterministic mode serializes it. (On the card that
    backward is sort-based and needs no such mode.)"""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def test_resume_equals_uninterrupted_bitwise(tmp_path, deterministic):
    full = build_session(_spec(4), device="cpu")
    hist = full.fit(log_every=1)
    build_session(_spec(2), device="cpu").fit(log_every=1, ckpt_dir=tmp_path)
    assert CheckpointManager(tmp_path).steps() == [1, 2]
    resumed = build_session(_spec(4), device="cpu")
    tail = resumed.fit(log_every=1, ckpt_dir=tmp_path, resume=True)
    assert [h["epoch"] for h in tail] == [3, 4]
    assert tail == hist[2:]
    assert _same_state(resumed.trainer.train_state(), full.trainer.train_state())
    assert CheckpointManager(tmp_path).steps() == [2, 3, 4]


def test_resume_needs_ckpt_dir_and_a_checkpoint(tmp_path):
    s = build_session(_spec(1), device="cpu")
    with pytest.raises(ValueError, match="resume.*ckpt_dir"):
        s.fit(resume=True)
    with pytest.raises(RuntimeError, match="no valid checkpoint"):
        s.fit(ckpt_dir=tmp_path / "empty", resume=True)


def test_ckpt_every_sets_the_snapshot_period(tmp_path):
    s = build_session(_spec(5).with_overrides(["exec.ckpt_every=2"]), device="cpu")
    s.fit(log_every=0, ckpt_dir=tmp_path)
    assert CheckpointManager(tmp_path).steps() == [2, 4, 5]
    meta = load_checkpoint(CheckpointManager(tmp_path).path_for(5))["manifest"]["meta"]
    assert meta["epoch"] == 5 and meta["mode"] == "vmap"
    assert meta["graph_hash"] == s.spec.graph.content_hash()
    assert meta["spec_hash"] == s.spec.content_hash()


def _serve_spec(*over):
    d = {"run": RunSpec.load(FLAGSHIP).with_overrides(VMAP).to_dict(),
         "serve": {"batch_size": 4, "min_nodes": 32, "fanouts": "full"}}
    return (ServeSpec.from_json(json.dumps(d)).with_overrides(list(over)),
            JServeSpec.from_json(json.dumps(d)).with_overrides(list(over)))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 2-epoch port run of the flagship spec checkpointed to a directory."""
    d = tmp_path_factory.mktemp("trained")
    s = build_session(_spec(2), device="cpu")
    s.fit(log_every=0, ckpt_dir=d)
    return s, d


def test_serve_ckpt_restores_the_trained_params(trained):
    session, d = trained
    tspec, _ = _serve_spec(f"serve.ckpt={d}")
    server = build_server(tspec, device="cpu")
    fresh = build_server(_serve_spec()[0], device="cpu")
    for a, b in zip(tree_leaves(server.params), tree_leaves(session.trainer.params)):
        assert torch.equal(a, b)
    assert not torch.equal(server.params["layers"][0]["w_neigh"],
                           fresh.params["layers"][0]["w_neigh"])
    full = server.full_batch_logits()
    assert np.array_equal(server.serve([9, 77]), full[[9, 77]])


def test_jax_server_serves_a_port_checkpoint(trained):
    _, d = trained
    tspec, jspec = _serve_spec(f"serve.ckpt={d}")
    jserver = j_build_server(jspec)
    tserver = build_server(tspec, device="cpu")
    np.testing.assert_allclose(tserver.full_batch_logits(),
                               np.asarray(jserver.full_batch_logits()), **TOL)


def test_serve_ckpt_refuses_other_graph_and_corrupt_snapshots(trained, tmp_path):
    _, d = trained
    with pytest.raises(ServeError, match="graph"):
        build_server(_serve_spec("graph.nodes=300", f"serve.ckpt={d}")[0], device="cpu")
    with pytest.raises(ServeError, match="does not fit"):
        build_server(_serve_spec("model.hidden_dim=16", f"serve.ckpt={d}")[0],
                     device="cpu")
    with pytest.raises(ServeError, match="no loadable checkpoint"):
        build_server(_serve_spec(f"serve.ckpt={tmp_path}")[0], device="cpu")
    # Newest snapshot corrupt: the server falls back to the previous one.
    mgr = CheckpointManager(tmp_path / "copy")
    src = CheckpointManager(d)
    for step in src.steps():
        for suffix in (".npz", ".json"):
            mgr.path_for(step).with_suffix(suffix).write_bytes(
                src.path_for(step).with_suffix(suffix).read_bytes())
    newest = mgr.path_for(mgr.steps()[-1]).with_suffix(".npz")
    newest.write_bytes(b"not a checkpoint")
    server = build_server(_serve_spec(f"serve.ckpt={mgr.dir}")[0], device="cpu")
    first = restore_train_state(mgr.path_for(mgr.steps()[0]),
                                {"params": server.params})[0]["params"]
    for a, b in zip(tree_leaves(server.params), tree_leaves(first)):
        assert torch.equal(a, b)


def test_launch_train_ckpt_dir_and_resume_on_cpu(tmp_path):
    base = ["--spec", str(FLAGSHIP), "--set", "exec.mode=vmap", "--device", "cpu",
            "--set", "exec.log_every=1", "--ckpt-dir", str(tmp_path)]
    out = io.StringIO()
    with redirect_stdout(out):
        assert tlaunch.main(base + ["--set", "exec.epochs=2", "--ckpt-every", "2"]) == 0
        assert CheckpointManager(tmp_path).steps() == [2]
        assert tlaunch.main(base + ["--set", "exec.epochs=3", "--resume"]) == 0
    text = out.getvalue()
    assert "epoch    2 loss" in text and "epoch    3 loss" in text
    assert text.count("epoch    1 loss") == 1          # the resumed run starts at 3
    assert CheckpointManager(tmp_path).steps() == [2, 3]
