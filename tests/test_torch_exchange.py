"""The port's stacked halo exchange against the JAX package's under ``vmap``.

The collectives (``_wire_a2a``, ``_pre_wire``, ``_post_wire``), the plan
lift, ``assemble_send`` / ``scatter_recv`` and whole ``LayerProgram``s —
flat and hierarchical, fp32 and Int2 wires, sync and delayed (``cd > 1``)
stages, overlap on and off — forward and gradient, on the fixtures of
``tests/test_exchange_schedule.py`` (an SBM graph, 2x4 workers) and
``tests/test_hier_halo.py`` (an R-MAT graph). The port's stochastic
rounding gets the uniforms the JAX package draws from its keys.
Tolerance rtol = atol = 1e-5 (sums in other orders).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graph as jg
from repro.core import exchange as jx

import repro_torch.graph as tg
from repro_torch.core import exchange as tx

G, W = 2, 4
P = G * W
F = 8
TOL = dict(rtol=1e-5, atol=1e-5)
BWD_FOLD = 0x5BD1


def _setup(pkg, source):
    if source == "sbm":
        g = pkg.sbm_graph(400, 4, avg_degree=10, homophily=0.85, seed=0)
    else:
        g = pkg.rmat_graph(9, 6, seed=3)
    gn = g.mean_normalized()
    part = pkg.partition_hierarchical(gn, G, W, seed=0)
    hpg = pkg.build_hierarchical_partitioned_graph(gn, G, W, part=part, seed=0)
    pgf = pkg.build_partitioned_graph(gn, P, part=part, seed=0)
    rows = max(4, (pgf.stats.padded_rows_per_pair + 3) // 4 * 4)
    return (gn, pkg.remote.build_halo_plan(pgf, rows_per_pair=rows),
            pkg.build_hier_halo_plan(hpg), pgf.max_owned)


@pytest.fixture(scope="module", params=["sbm", "rmat"])
def setup(request):
    _, jflat, jhier, m = _setup(jg, request.param)
    _, tflat, thier, m2 = _setup(tg, request.param)
    assert m == m2
    return SimpleNamespace(
        source=request.param, m=m,
        jflat=jx.stack_halo_plan(jflat, num_rows=m),
        jhier=jx.stack_hier_plan(jhier, num_rows=m),
        tflat=tx.stack_halo_plan(tflat, num_rows=m, device="cpu"),
        thier=tx.stack_hier_plan(thier, num_rows=m, device="cpu"))


def _nested(a):
    return a.reshape(G, W, *a.shape[1:])


def _vmapped(fn, hierarchical, in_axes):
    """``fn`` per worker under vmap (nested for the G x W layout), jitted."""
    if hierarchical:
        inner = jax.vmap(fn, axis_name="node", in_axes=in_axes)
        outer = jax.jit(jax.vmap(inner, axis_name="group", in_axes=in_axes))
        return lambda *a: outer(*jax.tree_util.tree_map(_nested, a))
    return jax.jit(jax.vmap(fn, axis_name="workers", in_axes=in_axes))


def _flatten(out):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a).reshape(P, *a.shape[2:]) if a.shape[:2] == (G, W)
        else np.asarray(a), out)


# -- the collectives ----------------------------------------------------------

TOPOS = {
    "flat": (jx.StageTopo("a2a", "workers", P),
             tx.StageTopo("a2a", "workers", P, lead=(1, P), wire_dim=1), False),
    "intra": (jx.StageTopo("a2a", "node", W),
              tx.StageTopo("a2a", "node", W, lead=(G, W), wire_dim=1), True),
    "inter": (jx.StageTopo("grouped", "group", G, "node", W),
              tx.StageTopo("grouped", "group", G, "node", W, lead=(G, W), wire_dim=0),
              True),
}


@pytest.mark.parametrize("topo", list(TOPOS))
@pytest.mark.parametrize("op", ["_wire_a2a", "_pre_wire", "_post_wire"])
def test_wire_primitives_match_vmap(topo, op):
    jt, tt, hier = TOPOS[topo]
    rows = {"flat": 4 * P, "intra": 3 * W, "inter": 2 * G * W}[topo]
    if op == "_post_wire" and topo == "inter":
        rows = 2 * G
    v = np.random.default_rng(rows).normal(size=(P, rows, 5)).astype(np.float32)
    want = _flatten(_vmapped(lambda a: getattr(jx, op)(a, jt), hier, 0)(jnp.asarray(v)))
    got = getattr(tx, op)(torch.from_numpy(v), tt)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# -- plans, assemble and scatter ------------------------------------------------


def _leaves_equal(jplan, tplan):
    for name in jx.DeviceHaloPlan._fields[:8]:
        np.testing.assert_array_equal(getattr(tplan, name).numpy(),
                                      np.asarray(getattr(jplan, name)), err_msg=name)
    for jl, tl in ((jplan.recv_ell, tplan.recv_ell), (jplan.recv_ell_t, tplan.recv_ell_t)):
        assert len(jl.buckets) == len(tl.buckets)
        for jb, tb in zip(jl.buckets, tl.buckets):
            for name in ("rows", "idx", "w"):
                np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                              np.asarray(getattr(jb, name)))
            assert tb.n == int(tb.counts.max())


def test_stacked_plans_equal(setup):
    _leaves_equal(setup.jflat, setup.tflat)
    _leaves_equal(setup.jhier.intra, setup.thier.intra)
    _leaves_equal(setup.jhier.inter, setup.thier.inter)


@pytest.mark.parametrize("backend", ["ell", "coo"])
@pytest.mark.parametrize("level", ["flat", "intra", "inter"])
def test_assemble_send_and_scatter_recv(setup, level, backend):
    jp = setup.jflat if level == "flat" else getattr(setup.jhier, level)
    tp = setup.tflat if level == "flat" else getattr(setup.thier, level)
    rng = np.random.default_rng(len(level))
    h = rng.normal(size=(P, setup.m, F)).astype(np.float32)
    wire = jp.send_gather_idx.shape[-1]
    recv = rng.normal(size=(P, wire, F)).astype(np.float32)
    jsend = jax.jit(jax.vmap(jx.assemble_send))(jnp.asarray(h), jp)
    jacc = jax.jit(jax.vmap(lambda a, r, pl: jx.scatter_recv(a, r, pl, backend)))(
        jnp.asarray(h), jnp.asarray(recv), jp)
    np.testing.assert_allclose(tx.assemble_send(torch.from_numpy(h), tp, backend).numpy(),
                               np.asarray(jsend), **TOL)
    np.testing.assert_allclose(
        tx.scatter_recv(torch.from_numpy(h), torch.from_numpy(recv), tp, backend).numpy(),
        np.asarray(jacc), **TOL)


def _padded_plan(source, m):
    """The flat plan of ``source`` at 12 times the rows a pair needs: at
    least 90% of its wire slots are padding."""
    gn = _setup(tg, source)[0]
    part = tg.partition_hierarchical(gn, G, W, seed=0)
    pgf = tg.build_partitioned_graph(gn, P, part=part, seed=0)
    rows = 12 * max(4, (pgf.stats.padded_rows_per_pair + 3) // 4 * 4)
    return tx.stack_halo_plan(tg.remote.build_halo_plan(pgf, rows_per_pair=rows),
                              num_rows=m, device="cpu")


def _entries(ell):
    """Per worker, the (row, source) pairs of a stacked layout's real
    entries (weight != 0)."""
    out = [set() for _ in range(ell.buckets[0].rows.shape[0])]
    for b in ell.buckets:
        for p, r, k in zip(*np.nonzero(b.w.numpy())):
            out[p].add((int(b.rows[p, r]), int(b.idx[p, r, k])))
    return out


@pytest.mark.parametrize("level", ["flat", "intra", "inter", "padded"])
def test_send_gather_over_the_layout(setup, level):
    """The ``ell`` send gather over ``send_ell`` against the index gather
    (the same plan without the layouts): the forward bit for bit with
    padding slots exactly 0, the gradient in ``h`` within 1e-6; the
    layouts hold one weight-1 entry per live slot and none for padding;
    the counters tell the two routes apart."""
    plan = {"flat": setup.tflat, "intra": setup.thier.intra, "inter": setup.thier.inter,
            "padded": None}[level]
    if plan is None:
        plan = _padded_plan(setup.source, setup.m)
        assert plan.live_share() <= 0.1
    mask, idx = plan.send_gather_mask.numpy(), plan.send_gather_idx.numpy()
    live = [{(int(s), int(idx[p, s])) for s in np.flatnonzero(mask[p])} for p in range(P)]
    assert _entries(plan.send_ell) == live
    assert _entries(plan.send_ell_t) == [{(r, s) for s, r in lv} for lv in live]
    for ell in (plan.send_ell, plan.send_ell_t):
        assert sum(int((b.w != 0).sum()) for b in ell.buckets) == int(mask.sum())
        assert all(set(np.unique(b.w.numpy())) <= {0.0, 1.0} for b in ell.buckets)

    rng = np.random.default_rng(len(level))
    h = torch.from_numpy(rng.normal(size=(P, setup.m, F)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(P, mask.shape[1], F)).astype(np.float32))
    index_plan = plan._replace(send_ell=None, send_ell_t=None)
    runs = {}
    for name, pl in (("layout", plan), ("index", index_plan)):
        x = h.clone().requires_grad_(True)
        before = tx.gather_counts()
        raw = tx._send_gather(x, pl, "ell")
        after = tx.gather_counts()
        assert {k: after[k] - before[k] for k in after} == {
            k: int(k == name) for k in after}
        runs[name] = (raw.detach(), torch.autograd.grad(raw, x, g)[0])
    (raw, dh), (want, want_dh) = runs["layout"], runs["index"]
    assert torch.equal(raw.view(torch.int32), want.view(torch.int32))
    assert not raw.view(torch.int32)[torch.from_numpy(~mask)].any()
    torch.testing.assert_close(dh, want_dh, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tx.assemble_send(h, plan, "ell").numpy(),
                                  tx.assemble_send(h, index_plan, "ell").numpy())


# -- whole layer programs --------------------------------------------------------


def _uniforms(keys, si, backward, shape):
    """The JAX package's stochastic-rounding uniforms of stage ``si`` for
    every worker (``LayerProgram._wire`` folds ``si``; the backward wire
    folds ``0x5BD1`` on top)."""
    rows, feat = shape[1:]
    out = []
    for key in keys:
        k = jax.random.fold_in(key, si)
        if backward:
            k = jax.random.fold_in(k, BWD_FOLD)
        out.append(np.asarray(jax.random.uniform(k, (rows // 4, 4, feat),
                                                 dtype=jnp.float32)).reshape(rows, feat))
    return torch.from_numpy(np.stack(out))


SCHEDULES = {
    "flat_fp32": lambda ov: jx.ExchangeSchedule.flat(P, overlap=ov),
    "flat_int2_cd3": lambda ov: jx.ExchangeSchedule.flat(P, bits=2, cd=3, overlap=ov),
    "hier_fp32": lambda ov: jx.ExchangeSchedule.hierarchical(G, W, overlap=ov),
    "hier_int2_inter_cd2": lambda ov: jx.ExchangeSchedule.hierarchical(
        G, W, inter_bits=2, inter_cd=2, overlap=ov),
    "hier_int2_both": lambda ov: jx.ExchangeSchedule.hierarchical(
        G, W, intra_bits=2, inter_bits=2, overlap=ov),
}


def _port_schedule(js):
    return tx.ExchangeSchedule(
        stages=tuple(tx.StageSpec(s.level, s.bits, s.cd, s.overlap) for s in js.stages),
        nparts=js.nparts, num_groups=js.num_groups, group_size=js.group_size)


# (graph, schedule, overlap, epoch): every schedule, the delayed ones on a
# refresh and a stale epoch, overlap both ways, two on the R-MAT graph's hub
# rows. tests/test_torch_train.py runs the flagship and flat fp32 schedules
# through whole training steps.
CASES = [("sbm", "flat_int2_cd3", False, 0), ("sbm", "flat_int2_cd3", True, 1),
         ("sbm", "hier_fp32", True, 0), ("sbm", "hier_int2_inter_cd2", True, 1),
         ("sbm", "hier_int2_both", False, 0), ("rmat", "flat_fp32", False, 0),
         ("rmat", "hier_int2_inter_cd2", True, 0)]


@pytest.mark.parametrize("setup,name,overlap,epoch", CASES, indirect=["setup"],
                         ids=["-".join(map(str, c)) for c in CASES])
def test_layer_program_matches_reference(setup, name, overlap, epoch):
    js = SCHEDULES[name](overlap)
    ts = _port_schedule(js)
    hier = js.is_hierarchical
    backend = "ell"
    rng = np.random.default_rng(epoch * 10 + len(name))
    h = rng.normal(size=(P, setup.m, F)).astype(np.float32)
    g = rng.normal(size=(P, setup.m, F)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), P)
    jplan = setup.jhier if hier else setup.jflat
    tplan = setup.thier if hier else setup.tflat
    carrier = lambda pl: SimpleNamespace(plan=None if hier else pl,
                                         hier_plan=pl if hier else None)
    rows = js.cache_rows(carrier(jplan))
    cache = tuple(rng.normal(size=(P, r, F)).astype(np.float32) for r in rows)

    def worker(hh, pl, key, ce, gg):
        prog = js.layer_program(carrier(pl), agg_backend=backend)

        def f(x):
            inflight = prog.issue(x, key, cache_entry=ce or None, epoch=epoch)
            return prog.finalize(0.5 * x, inflight)

        out, vjp, entry = jax.vjp(f, hh, has_aux=True)
        return out, entry, vjp(gg)[0]

    jout, jentry, jdh = _flatten(_vmapped(worker, hier, 0)(
        jnp.asarray(h), jplan, keys, tuple(jnp.asarray(c) for c in cache),
        jnp.asarray(g)))

    prog = ts.layer_program(carrier(tplan), agg_backend=backend)
    ht = torch.from_numpy(h).requires_grad_(True)
    noise = lambda si, backward, shape: _uniforms(keys, si, backward, shape)
    inflight = prog.issue(ht, noise, cache_entry=[torch.from_numpy(c) for c in cache]
                          or None, epoch=epoch)
    out, entry = prog.finalize(0.5 * ht, inflight)
    (dh,) = torch.autograd.grad(out, ht, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), jout, **TOL)
    np.testing.assert_allclose(dh.numpy(), jdh, **TOL)
    assert len(entry) == len(jentry) == len(rows)
    for a, b in zip(entry, jentry):
        np.testing.assert_allclose(a.numpy(), b, **TOL)
