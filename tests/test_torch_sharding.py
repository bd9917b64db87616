"""The port's sharding rules (``repro_torch.sharding``), production meshes
(``repro_torch.launch.mesh``) and input specs (``repro_torch.launch.input_specs``)
against the JAX package's.

The JAX package's specs are taken over ``jax.eval_shape`` trees on
``repro.sharding.compat.abstract_mesh`` meshes of the production shapes,
as ``tests/test_sharding.py`` builds them; the port's over its meta-device
trees on ``make_production_mesh``. One rule converts a reference
``PartitionSpec`` to the port's tuple form: each entry as JAX holds it
(``None``, an axis name, or a tuple of names made a Python tuple). JAX
normalizes a one-name tuple to its name, and the port keeps that form.
"""

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_NAMES, INPUT_SHAPES, get_arch, get_shape
from repro.launch import input_specs as jinput
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.sharding import specs as jspecs
from repro.sharding.compat import abstract_mesh
from repro_torch import configs as TC
from repro_torch.launch import input_specs as tinput
from repro_torch.launch.mesh import (Mesh, make_hier_worker_mesh, make_production_mesh,
                                     make_worker_mesh)
from repro_torch.models.transformer import init_cache as tinit_cache
from repro_torch.models.transformer import init_params as tinit_params
from repro_torch.sharding import specs as tspecs
from repro_torch.utils.trees import tree_leaves

MESHES = {"16x16": ((16, 16), ("data", "model"), False),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"), True)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the test runner runs several workers side by
    side, and PyTorch's CPU thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _entry(e):
    return e if e is None or isinstance(e, str) else tuple(e)


def _ref_form(tree):
    """A reference spec tree in the port's form: PartitionSpecs as tuples
    (the one rule above), NamedTuples as dicts of their fields."""
    if isinstance(tree, P):
        return tuple(_entry(e) for e in tree)
    if isinstance(tree, dict):
        return {k: _ref_form(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return {f: _ref_form(v) for f, v in zip(tree._fields, tree)}
    if isinstance(tree, (list, tuple)):
        return [_ref_form(v) for v in tree]
    assert tree is None, type(tree)
    return None


def _port_form(tree):
    """The port's spec tree with NamedTuples as dicts; specs (plain tuples)
    stay leaves."""
    if isinstance(tree, dict):
        return {k: _port_form(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return {f: _port_form(v) for f, v in zip(tree._fields, tree)}
    if isinstance(tree, list):
        return [_port_form(v) for v in tree]
    assert tree is None or isinstance(tree, tuple), type(tree)
    return tree


def _meshes(name):
    sizes, names, multi_pod = MESHES[name]
    return abstract_mesh(sizes, names), make_production_mesh(multi_pod=multi_pod)


def test_production_and_worker_meshes():
    for name, (sizes, names, multi_pod) in MESHES.items():
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert mesh.axis_names == names and mesh.sizes == sizes
        assert mesh.shape == dict(zip(names, sizes))
        ref = abstract_mesh(sizes, names)
        assert {a: int(ref.shape[a]) for a in ref.axis_names} == mesh.shape
    assert make_worker_mesh(8).shape == {"workers": 8}
    assert make_hier_worker_mesh(2, 4).shape == {"group": 2, "node": 4}
    with pytest.raises(ValueError):
        Mesh(("data",), (2, 2))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_specs_match_the_reference(name):
    shapes = jax.eval_shape(lambda k: jinit_params(k, get_arch(name)),
                            jax.random.PRNGKey(0))
    meta = tinit_params(None, TC.get_arch(name), device="meta")
    for mesh_name in MESHES:
        jmesh, tmesh = _meshes(mesh_name)
        for fsdp in (True, False):
            want = _ref_form(jspecs.param_specs(shapes, jmesh, fsdp=fsdp))
            got = _port_form(tspecs.param_specs(meta, tmesh, fsdp=fsdp))
            assert got == want, (mesh_name, fsdp)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_cache_specs_match_the_reference(name):
    shape = get_shape("decode_32k")
    b = shape.global_batch
    window = jinput.effective_window(get_arch(name), shape)
    cache = jax.eval_shape(lambda: jinit_cache(get_arch(name), b, shape.seq_len,
                                               window=window))
    meta = tinit_cache(TC.get_arch(name), b, shape.seq_len, window=window, device="meta")
    for mesh_name in MESHES:
        jmesh, tmesh = _meshes(mesh_name)
        want = _ref_form(jspecs.cache_specs(cache, jmesh, b))
        got = _port_form(tspecs.cache_specs(meta, tmesh, b))
        assert got == want, mesh_name


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_and_array_specs_match_the_reference(mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    assert tspecs.data_axes(tmesh) == jspecs.data_axes(jmesh)
    for batch in (1, 32, 128, 256, 512):
        for extra in (1, 2):
            assert tspecs.batch_spec(tmesh, batch, extra) == _ref_form(
                jspecs.batch_spec(jmesh, batch, extra))
        x = torch.empty((batch, 7), device="meta")
        for b in (None, batch):
            assert tspecs.spec_for_array(x, tmesh, b) == _ref_form(
                jspecs.spec_for_array(jax.ShapeDtypeStruct((batch, 7), "float32"),
                                      jmesh, b))


class _FakeMesh:
    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")


def test_skip_window_and_microbatch_rules():
    """The cases of tests/test_sharding.py's test_skip_rules and
    test_microbatch_token_budget, then every (arch, shape) pair against
    the reference's functions."""
    whisper, long = TC.get_arch("whisper-small"), TC.get_shape("long_500k")
    assert tinput.skip_reason(whisper, long)
    assert tinput.skip_reason(whisper, TC.get_shape("decode_32k")) is None
    dense = TC.get_arch("llama3.2-3b")
    assert tinput.skip_reason(dense, long) is None
    assert tinput.effective_window(dense, long) == 8192
    assert tinput.effective_window(dense, TC.get_shape("train_4k")) is None
    assert tinput.effective_window(TC.get_arch("xlstm-350m"), long) is None
    train = TC.get_shape("train_4k")
    nm = tinput.num_microbatches(TC.get_arch("tinyllama-1.1b"), train, _FakeMesh())
    assert train.global_batch % nm == 0
    assert train.global_batch * train.seq_len // 16 // nm <= tinput.MB_TOKENS_PER_DEVICE
    assert (tinput.LONG_CONTEXT_WINDOW, tinput.MB_TOKENS_PER_DEVICE) == (
        jinput.LONG_CONTEXT_WINDOW, jinput.MB_TOKENS_PER_DEVICE)
    for name in ARCH_NAMES:
        for s in INPUT_SHAPES:
            ta, ts, ja, js = TC.get_arch(name), TC.get_shape(s), get_arch(name), get_shape(s)
            assert tinput.skip_reason(ta, ts) == jinput.skip_reason(ja, js)
            assert tinput.effective_window(ta, ts) == jinput.effective_window(ja, js)
            for mesh_name in MESHES:
                jmesh, tmesh = _meshes(mesh_name)
                assert tinput.num_microbatches(ta, ts, tmesh) == jinput.num_microbatches(
                    ja, js, jmesh)


def _leaves(rec):
    return [leaf for key in ("params", "opt_state", "batch", "cache", "tokens")
            if key in rec for leaf in tree_leaves(rec[key])]


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_input_specs_are_meta_and_shard_by_their_specs(name):
    arch = TC.get_arch(name)
    for mesh_name in MESHES:
        _, mesh = _meshes(mesh_name)
        for s in INPUT_SHAPES:
            rec = tinput.input_specs(arch, s, mesh)
            if "skip" in rec:
                assert (name, s) == ("whisper-small", "long_500k")
                continue
            kind = rec["shape"].kind
            assert set(rec) == {"params", "param_specs", "window", "shape"} | {
                "train": {"opt_state", "batch", "num_microbatches"},
                "prefill": {"batch"}, "decode": {"cache", "tokens"}}[kind]
            leaves = _leaves(rec)
            assert leaves and all(isinstance(x, tinput.Sharded) for x in leaves)
            for leaf in leaves:
                assert leaf.tensor.device.type == "meta"
                assert len(leaf.spec) <= len(leaf.shape)
                want = list(leaf.shape)
                for i, axes in enumerate(leaf.spec):
                    if axes is not None:
                        n = 1
                        for a in ((axes,) if isinstance(axes, str) else axes):
                            n *= mesh.shape[a]
                        assert want[i] % n == 0, (name, s, leaf.shape, leaf.spec)
                        want[i] //= n
                assert leaf.shard_shape == tuple(want)
            # Parameters: training keeps FSDP, inference is TP-only.
            assert _port_form(rec["param_specs"]) == _port_form(tspecs.param_specs(
                tinit_params(None, arch, device="meta"), mesh, fsdp=kind == "train"))
            if kind == "train":
                opt = rec["opt_state"]
                assert opt.step.shape == () and opt.step.spec == ()
                for p, m, v in zip(tree_leaves(rec["params"]), tree_leaves(opt.mu),
                                   tree_leaves(opt.nu)):
                    assert p.spec == m.spec == v.spec and p.shape == m.shape == v.shape
                    assert m.tensor is not p.tensor
