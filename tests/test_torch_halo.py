"""The port's one-call halo wrappers (``repro_torch.core.halo``) against
``repro.core.halo`` under ``vmap``, on the R-MAT cases of
``tests/test_hier_halo.py``: flat and hierarchical 2x4 exchanges, fp32 and
quantized wires, the received buffers, the full aggregation and its
gradient. The quantized wires get the uniforms the JAX package draws from
its keys (per worker, folded per level and for the backward).
Tolerance rtol = atol = 1e-5 (sums in other orders); on integer features
with unit weights every sum is exact, and the two must agree bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graph as jg
from repro.core import halo as jh

import repro_torch.graph as tg
from repro_torch.core import halo as th

G, W = 2, 4
P = G * W
TOL = dict(rtol=1e-5, atol=1e-5)
BWD_FOLD = 0x5BD1


def _plans(pkg, normalize):
    g = pkg.rmat_graph(9, 6, seed=3)
    part = pkg.partition_hierarchical(g, G, W, seed=0)
    if normalize:
        g = g.mean_normalized()
    hpg = pkg.build_hierarchical_partitioned_graph(g, G, W, part=part,
                                                   strategy="hybrid", seed=0)
    pgf = pkg.build_partitioned_graph(g, P, part=part, strategy="hybrid", seed=0)
    rows = max(4, (pgf.stats.padded_rows_per_pair + 3) // 4 * 4)
    return (g, pgf, pkg.remote.build_halo_plan(pgf, rows_per_pair=rows),
            pkg.build_hier_halo_plan(hpg))


def _worker_inputs(g, pg, x):
    """Stacked owned features and each worker's local aggregation."""
    xs = np.zeros((P, pg.max_owned, x.shape[1]), np.float32)
    local = np.zeros_like(xs)
    for p in range(P):
        o = pg.owned[p]
        xs[p, :len(o)] = x[o]
        c = pg.local_csr[p]
        dst = np.repeat(np.arange(c.num_rows), np.diff(c.indptr))
        np.add.at(local[p], dst, c.weights[:, None] * xs[p][c.indices])
    return xs, local


@pytest.fixture(scope="module", params=["normalized", "integer"])
def case(request):
    normalize = request.param == "normalized"
    g, pgf, jflat, jhier = _plans(jg, normalize)
    _, pgt, tflat, thier = _plans(tg, normalize)
    rng = np.random.default_rng(1)
    if normalize:
        x = rng.normal(size=(g.num_nodes, 8)).astype(np.float32)
    else:
        x = rng.integers(0, 8, size=(g.num_nodes, 16)).astype(np.float32)
    xs, local = _worker_inputs(g, pgf, x)
    return dict(exact=not normalize, xs=xs, local=local,
                jflat=jh.stack_halo_plan(jflat), jhier=jh.stack_hier_plan(jhier),
                tflat=th.stack_halo_plan(tflat, device="cpu"),
                thier=th.stack_hier_plan(thier, device="cpu"))


def _nested(a):
    return a.reshape(G, W, *a.shape[1:])


def _keys():
    return jax.random.split(jax.random.PRNGKey(7), P)


def _uniform(key, rows, feat, *folds):
    for f in folds:
        key = jax.random.fold_in(key, f)
    u = jax.random.uniform(key, (rows // 4, 4, feat), dtype=jnp.float32)
    return np.asarray(u).reshape(rows, feat)


def _flat_noise(keys):
    def noise(backward, shape):
        folds = (BWD_FOLD,) if backward else ()
        return torch.from_numpy(np.stack([_uniform(k, *shape[1:], *folds) for k in keys]))
    return noise


def _hier_noise(keys):
    """The JAX package folds 1 (intra) and 2 (inter) into the key."""
    def noise(stage, backward, shape):
        folds = (stage + 1,) + ((BWD_FOLD,) if backward else ())
        return torch.from_numpy(np.stack([_uniform(k, *shape[1:], *folds) for k in keys]))
    return noise


def _check(got, want, exact):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


def _local_grad(fn, h):
    """One worker's gradient of its own ``sum(out ** 2)`` under vmap: the
    collectives' transposes carry every worker's cotangent back to the
    sender, so it is the gradient of the sum over all workers."""
    return jax.grad(lambda hh: jnp.sum(fn(hh) ** 2))(h)


def _grad(fn, xs):
    h = torch.from_numpy(xs).requires_grad_(True)
    out = fn(h)
    (g,) = torch.autograd.grad(out.pow(2).sum(), h)
    return out, g


def test_flat_fp32_exchange(case):
    jrecv = jax.vmap(lambda h, pl: jh.halo_exchange_fp32(h, pl, "workers", P),
                     axis_name="workers")(jnp.asarray(case["xs"]), case["jflat"])
    got = th.halo_exchange_fp32(torch.from_numpy(case["xs"]), case["tflat"], "workers", P)
    _check(got, jrecv, case["exact"])


@pytest.mark.parametrize("case,bits", [("normalized", 0), ("normalized", 2),
                                       ("integer", 0)], indirect=["case"])
def test_flat_exchange_and_aggregate(case, bits):
    keys = _keys()

    def worker(h, loc, pl, key):
        k = key if bits else None
        agg = lambda hh: jh.aggregate_with_halo(hh, loc, pl, "workers", P, bits=bits,
                                                key=k)
        return (jh.halo_exchange(h, pl, "workers", P, bits=bits, key=k), agg(h),
                _local_grad(agg, h))

    want = jax.jit(jax.vmap(worker, axis_name="workers"))(
        case["xs"], case["local"], case["jflat"], keys)
    noise = _flat_noise(keys) if bits else None
    loc = torch.from_numpy(case["local"])
    recv = th.halo_exchange(torch.from_numpy(case["xs"]), case["tflat"], "workers", P,
                            bits=bits, noise=noise)
    got, dgot = _grad(lambda h: th.aggregate_with_halo(
        h, loc, case["tflat"], "workers", P, bits=bits, noise=noise), case["xs"])
    exact = case["exact"] and not bits
    _check(recv, want[0], exact)
    _check(got, want[1], exact)
    np.testing.assert_allclose(dgot.numpy(), np.asarray(want[2]), **TOL)


@pytest.mark.parametrize("case,bits", [("normalized", 0), ("normalized", 2),
                                       ("normalized", 8), ("integer", 0)],
                         indirect=["case"])
def test_hierarchical_exchange_and_aggregate(case, bits):
    keys = _keys()

    def worker(h, loc, pl, key):
        k = key if bits else None
        agg = lambda hh: jh.aggregate_with_halo_hierarchical(
            hh, loc, pl, "node", "group", W, G, bits=bits, key=k)
        return (*jh.halo_exchange_hierarchical(h, pl, "node", "group", W, G,
                                               bits=bits, key=k),
                agg(h), _local_grad(agg, h))

    args = jax.tree_util.tree_map(_nested, (case["xs"], case["local"], case["jhier"],
                                            keys))
    want = jax.jit(jax.vmap(jax.vmap(worker, axis_name="node"), axis_name="group"))(*args)
    want = [np.asarray(a).reshape(P, *a.shape[2:]) for a in want]
    noise = _hier_noise(keys) if bits else None
    loc = torch.from_numpy(case["local"])
    recv_i, recv_e = th.halo_exchange_hierarchical(
        torch.from_numpy(case["xs"]), case["thier"], "node", "group", W, G,
        bits=bits, noise=noise)
    got, dgot = _grad(lambda h: th.aggregate_with_halo_hierarchical(
        h, loc, case["thier"], "node", "group", W, G, bits=bits, noise=noise),
        case["xs"])
    exact = case["exact"] and not bits
    _check(recv_i, want[0], exact)
    _check(recv_e, want[1], exact)
    _check(got, want[2], exact)
    np.testing.assert_allclose(dgot.numpy(), want[3], **TOL)


@pytest.mark.parametrize("case", ["integer"], indirect=True)
def test_hierarchical_equals_flat_on_exact_sums(case):
    """On integer features with unit weights the two-level aggregation and
    the flat one agree bitwise in the port too (paper contribution 2)."""
    xs, loc = torch.from_numpy(case["xs"]), torch.from_numpy(case["local"])
    flat = th.aggregate_with_halo(xs, loc, case["tflat"], "workers", P)
    hier = th.aggregate_with_halo_hierarchical(xs, loc, case["thier"], "node",
                                               "group", W, G)
    assert torch.equal(flat, hier)


def test_quantized_wrappers_need_noise(case):
    xs = torch.from_numpy(case["xs"])
    with pytest.raises(ValueError, match="noise"):
        th.halo_exchange(xs, case["tflat"], "workers", P, bits=2)
    with pytest.raises(ValueError, match="noise"):
        th.halo_exchange_hierarchical(xs, case["thier"], "node", "group", W, G, bits=2)
