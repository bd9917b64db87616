"""The LM half of the port's dry-run (``repro_torch.launch.dryrun``) and its
roofline (``repro_torch.launch.roofline``) against the JAX package's.

* The JAX package's own dry-run case (whisper-small x decode_32k on the
  16x16 mesh) through the port's ``main`` on the CPU.
* Dot FLOPs: the port's ``FlopCounterMode`` count of each smoke config's
  ``forward_train``, ``serve_step`` and ``train_step`` (2 micro-batches,
  every output kept) against ``repro.launch.hlo_stats.analyze_hlo`` on the
  JAX step compiled for the CPU. The two are equal except where the
  difference is reckoned by name below (ROADMAP C-ref15 and C-ref16).
* ``cost_extrapolate``'s estimate against a full-depth trace at production
  widths, 4 layer quanta deep: FLOPs exactly, bytes within 1%.
* ``argument_size_in_bytes`` against the JAX package's own input specs on
  an abstract production mesh, each leaf's dims divided by the axes its
  spec names.
* ``roofline`` on the records written, with the JAX package's
  ``n_active_params`` and ``model_flops_per_device`` for all ten configs.
"""

import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_arch as jget_arch
from repro.configs import get_shape as jget_shape
from repro.configs import get_smoke_arch as jsmoke
from repro.launch import input_specs as jinput
from repro.launch import roofline as jroofline
from repro.launch.hlo_stats import analyze_hlo
from repro.models import transformer as JT
from repro.optim import adamw_init
from repro.sharding.compat import abstract_mesh
from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, get_arch, get_smoke_arch
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.launch.input_specs import input_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as TT
from repro_torch.optim.adamw import AdamWState
from repro_torch.utils.trees import tree_map

ROOT = Path(__file__).resolve().parents[1]
B, NM = 2, 2            # rows of a micro-batch; train_step's micro-batches
CACHE = 128             # serve_step's cache length
KINDS = ("forward", "serve", "train")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the test runner runs several workers side by
    side, and PyTorch's CPU thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seq(name: str) -> int:
    # zamba2 at two SSD chunks of 32, so its chunk loop carries a state;
    # xLSTM at one sLSTM chunk of 16 steps (a step is a loop trip here).
    return {"zamba2-2.7b": 64, "xlstm-350m": 16}.get(name, 32)


# --------------------------------------------------------------- dot FLOPs


def _jbatch(cfg, b, s):
    bt = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    if cfg.family == "audio":
        bt["frames"] = jax.ShapeDtypeStruct((b, cfg.enc_frames, cfg.d_model), jnp.float32)
    if cfg.family == "vlm":
        bt["patches"] = jax.ShapeDtypeStruct((b, 4, cfg.d_model), jnp.float32)
    return bt


def _jax_flops(cfg, kind, s):
    params = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), cfg))
    if kind == "forward":
        def fwd(p, bt):
            extra = {k: v for k, v in bt.items() if k != "tokens"}
            return JT.forward_train(p, cfg, bt["tokens"], extra or None, None)
        lowered = jax.jit(fwd).lower(params, _jbatch(cfg, B, s))
    elif kind == "serve":
        cache = jax.eval_shape(lambda: JT.init_cache(cfg, B, CACHE))
        lowered = jax.jit(lambda p, c, t: JT.serve_step(p, c, t, cfg)).lower(
            params, cache, jax.ShapeDtypeStruct((B, 1), jnp.int32))
    else:
        opt = jax.eval_shape(lambda: adamw_init(JT.init_params(jax.random.PRNGKey(0), cfg)))
        # All three outputs kept: a step that returns the loss alone lets
        # XLA drop the backward.
        lowered = jax.jit(lambda p, o, b: JT.train_step(p, o, b, cfg, num_microbatches=NM)
                          ).lower(params, opt, _jbatch(cfg, NM * B, s))
    return analyze_hlo(lowered.compile().as_text())["dot_flops"]


def _tbatch(cfg, b, s):
    bt = {"tokens": torch.zeros((b, s), dtype=torch.int32, device="meta")}
    if cfg.family == "audio":
        bt["frames"] = torch.empty((b, cfg.enc_frames, cfg.d_model), device="meta")
    if cfg.family == "vlm":
        bt["patches"] = torch.empty((b, 4, cfg.d_model), device="meta")
    return bt


def _port_flops(cfg, kind, s):
    """``FlopCounterMode``'s count of the port's step on meta tensors (shapes
    only: the count is the dry-run's, which traces the same step on fake
    tensors, in half the time)."""
    params = TT.init_params(None, cfg, device="meta")
    counter = FlopCounterMode(display=False)
    with counter:
        if kind == "forward":
            bt = _tbatch(cfg, B, s)
            extra = {k: v for k, v in bt.items() if k != "tokens"}
            with torch.no_grad():
                TT.forward_train(params, cfg, bt["tokens"], extra or None, None)
        elif kind == "serve":
            cache = TT.init_cache(cfg, B, CACHE, device="meta")
            tokens = torch.zeros((B, 1), dtype=torch.int32, device="meta")
            with torch.no_grad():
                TT.serve_step(params, cache, tokens, cfg)
        else:
            opt = AdamWState(0, tree_map(torch.zeros_like, params),
                             tree_map(torch.zeros_like, params))
            TT.train_step(params, opt, _tbatch(cfg, NM * B, s), cfg, num_microbatches=NM)
    return counter.get_total_flops()


def _shared_block_flops(cfg, kind, s):
    """The port's FLOPs of one application of zamba2's shared attention
    block: its forward over [B, s] tokens, or its decode step."""
    shared = TT.init_params(None, cfg, device="meta")["shared_attn"]
    h = torch.empty((B, s if kind != "serve" else 1, cfg.d_model), dtype=torch.bfloat16,
                    device="meta")
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        if kind == "serve":
            cache = TT.init_cache(cfg, B, CACHE, device="meta").extra
            TT._dense_block_decode(shared, h, TT._layer(cache, 0), cfg)
        else:
            positions = torch.arange(s, device="meta")[None].expand(B, s)
            TT._dense_block_train(shared, h, positions, cfg)
    return counter.get_total_flops()


def reckoned(name: str, cfg, kind: str, s: int) -> int:
    """JAX count - port count, by name (ROADMAP C-ref15, C-ref16); 0 elsewhere.

    * zamba2, every step (C-ref15): ``analyze_hlo`` counts every branch of
      a ``conditional`` on every trip, so the shared attention block counts
      in all L layers, not in the L / attn_every that run it (in training
      its forward and its two backward products, 3x, a micro-batch).
    * zamba2's training step (C-ref16): the reference's chunk scan
      transposes its elementwise einsum factors as dots with no contracted
      dimension (2·B·Q·H·(P + 4N) a chunk, counted; the port multiplies),
      and with two or more chunks its loop also computes the zero initial
      state's cotangent (3 products of 2·B·H·P·N·Q), which autograd skips.
    * xLSTM's training step (C-ref16): the reference checkpoints each
      sLSTM chunk inside the checkpointed group, so its backward runs the
      recurrence once more (S recurrent products of 2·B·H·P·4P), and it
      computes the zero initial state's cotangent (one more).
    * whisper's training step (C-ref16): the reference projects the cross
      K/V inside its checkpointed decoder block, so its backward projects
      them again (2 products of 2·B·F·D·KV·hd a layer); the port projects
      them once in ``encode_cross_kv``.
    * MoE training steps (C-ref16, a negative term): the port's block
      recompute re-runs the block's last products, the combine (2·T·K·D)
      and the shared expert's down projection (2·T·F_shared·D), which the
      reference's rematerialization leaves out, and autograd takes the
      combine's gradient in its expert outputs as a product over a unit
      dimension (2·T·K·D, counted; XLA multiplies).
    """
    if kind != "train" and name != "zamba2-2.7b":
        return 0
    L = cfg.num_layers
    if name == "zamba2-2.7b":
        skipped = L - L // cfg.attn_every
        out = skipped * (3 * NM if kind == "train" else 1) * _shared_block_flops(cfg, kind, s)
        if kind == "train":
            m = cfg.mamba
            q, h, p, n = m.chunk, m.num_heads, m.head_dim, m.state_dim
            nc = s // q
            elementwise = 2 * B * q * h * (p + 4 * n)
            per_layer = nc * elementwise
            if nc >= 2:
                per_layer += 3 * 2 * B * h * p * n * q
            out += NM * L * per_layer
        return out
    if cfg.family == "ssm":
        x = cfg.xlstm
        hd = x.head_dim
        groups = L // cfg.xlstm_group
        return NM * groups * (s + 1) * 2 * B * x.num_heads * hd * 4 * hd
    if cfg.family == "audio":
        return NM * L * 2 * 2 * B * cfg.enc_frames * cfg.d_model * cfg.num_kv_heads * cfg.hd
    if cfg.moe is not None:
        t, m = B * s, cfg.moe
        per_layer = 2 * (2 * t * m.top_k * cfg.d_model)
        per_layer += 2 * t * m.num_shared * m.d_ff_expert * cfg.d_model
        return -NM * L * per_layer
    return 0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_dot_flops_match_the_jax_package(name, kind):
    s = _seq(name)
    want = _jax_flops(jsmoke(name), kind, s)
    cfg = get_smoke_arch(name)
    got = _port_flops(cfg, kind, s)
    assert got > 0
    assert want - got == reckoned(name, cfg, kind, s), (name, kind, want, got)


# ------------------------------------------------------------- the records


def test_jax_packages_dry_run_case_through_main(tmp_path):
    """whisper-small x decode_32k on 16x16, the JAX package's integration
    case, through ``main`` on the CPU: exit 0, status ok, positive FLOPs and
    memory, the record under --out and nothing in experiments/dryrun/."""
    jax_dir = ROOT / "experiments" / "dryrun"
    before = sorted(jax_dir.glob("*")) if jax_dir.exists() else []
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "whisper-small", "--shape", "decode_32k", "--device", "cpu",
                "--out", str(tmp_path), "--hlo-out"])
    assert e.value.code == 0
    rec = json.loads((tmp_path / "whisper-small__decode_32k__16x16.json").read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256 and rec["kind"] == "decode"
    assert rec["hlo_analysis"]["dot_flops"] > 0 and rec["cost"]["flops"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0
    assert rec["collectives"]["total"]["wire_bytes"] is None
    assert "compile_s" not in rec and "hlo_bytes" not in rec and rec["trace_s"] >= 0
    ops = json.loads((tmp_path / "whisper-small__decode_32k__16x16.ops.json").read_text())
    assert sum(sum(v.values()) for v in ops["flop_counts"].values()) > 0
    assert (sorted(jax_dir.glob("*")) if jax_dir.exists() else []) == before


def test_skip_record_for_whisper_long_context(tmp_path):
    rec = D.run_one("whisper-small", "long_500k", False, out_dir=tmp_path, device="cpu")
    assert rec["status"] == "skip" and "whisper" in rec["skip_reason"]
    assert json.loads((tmp_path / "whisper-small__long_500k__16x16.json").read_text()
                      )["status"] == "skip"


CASES = [("tinyllama-1.1b", "decode_32k"), ("tinyllama-1.1b", "train_4k"),
         ("granite-moe-1b-a400m", "decode_32k"), ("zamba2-2.7b", "decode_32k")]


@pytest.mark.parametrize("name,shape", CASES)
def test_cost_extrapolate_equals_the_exact_trace(name, shape, monkeypatch, tmp_path):
    """At production widths, 4 layer quanta deep: the L1/L2 estimate equals
    the full-depth trace in FLOPs exactly and in bytes within 1%."""
    full = get_arch(name)
    arch = D.reduced_arch(full, 4 * D._layer_quantum(full))
    monkeypatch.setattr(D, "get_arch", lambda n: arch)
    # train_4k on the 2x16x16 mesh: 4 micro-batches there, 8 on 16x16.
    multi_pod = shape == "train_4k"
    mesh = make_production_mesh(multi_pod=multi_pod)
    ext = D.cost_extrapolate(name, shape, mesh, device="cpu")
    assert ext["L1"] == D._layer_quantum(full) and ext["L2"] == 2 * ext["L1"]
    assert ext["num_microbatches"] == (4 if multi_pod else 1)
    rec = D.run_one(name, shape, multi_pod, out_dir=tmp_path, device="cpu", exact=True)
    assert rec["status"] == "ok", rec.get("error")
    exact_flops = rec["hlo_analysis"]["dot_flops"] * rec["chips"]
    exact_bytes = rec["hlo_analysis"]["traffic_bytes"] * rec["chips"]
    assert ext["estimated_full"]["flops"] == exact_flops
    assert abs(ext["estimated_full"]["bytes accessed"] / exact_bytes - 1) < 0.01


# --------------------------------------------------------------- argument bytes

MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


def _jax_argument_bytes(name, shape_name, multi_pod):
    """The JAX package's input specs on an abstract mesh: each leaf's shape
    divided dim by dim by the sizes of the axes its spec names."""
    sizes, names = MESHES[multi_pod]
    mesh = abstract_mesh(sizes, names)
    axis = dict(zip(names, sizes))
    rec = jinput.input_specs(jget_arch(name), shape_name, mesh)
    total = 0
    for key in ("params", "opt_state", "batch", "cache", "tokens"):
        for leaf in jax.tree_util.tree_leaves(rec.get(key)):
            dims = list(leaf.shape)
            for i, entry in enumerate(leaf.sharding.spec):
                for a in (() if entry is None else
                          (entry,) if isinstance(entry, str) else entry):
                    dims[i] //= axis[a]
            total += math.prod(dims) * jnp.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_argument_bytes_follow_the_jax_packages_rules(name):
    arch = get_arch(name)
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        chips = math.prod(mesh.sizes)
        for shape_name in INPUT_SHAPES:
            spec = input_specs(arch, shape_name, mesh)
            if "skip" in spec:
                continue
            mem = D._mem_dict(spec, arch.vocab_size, 0.0, mesh, chips)
            assert mem["argument_size_in_bytes"] == _jax_argument_bytes(
                name, shape_name, multi_pod), (name, shape_name, multi_pod)


# --------------------------------------------------------------- roofline


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_roofline_model_flops_match_the_jax_package(name):
    assert R.n_active_params(get_arch(name)) == jroofline.n_active_params(jget_arch(name))
    for shape_name in INPUT_SHAPES:
        for chips in (256, 512):
            assert R.model_flops_per_device(
                get_arch(name), INPUT_SHAPES[shape_name], chips) == \
                jroofline.model_flops_per_device(jget_arch(name), jget_shape(shape_name), chips)


def test_roofline_on_the_records_written(tmp_path, capsys):
    """The records of two combinations and a skip, read back by the
    roofline's CLI: H100 constants, no collective term, the table and its
    JSON beside the records."""
    for name, shape in (("whisper-small", "decode_32k"), ("granite-moe-1b-a400m",
                                                          "decode_32k")):
        assert D.run_one(name, shape, False, out_dir=tmp_path, device="cpu")["status"] == "ok"
    D.run_one("whisper-small", "long_500k", False, out_dir=tmp_path, device="cpu")
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 450e9)
    rows = R.main(["--records", str(tmp_path)])
    out = capsys.readouterr().out
    assert "| whisper-small | long_500k | — | — | — | SKIP |" in out
    assert "collective term: not recorded" in out
    ok = [r for r in rows if r["status"] == "ok"]
    assert len(ok) == 2 and len(rows) == 3
    for r in ok:
        rec = json.loads((tmp_path / f"{r['arch']}__{r['shape']}__16x16.json").read_text())
        assert r == R.analyze_record(rec)
        assert r["t_collective_s"] is None and r["dominant"] in ("compute", "memory")
        assert r["t_compute_s"] == rec["hlo_analysis"]["dot_flops"] / 989e12
        mem = rec["memory"]
        assert r["t_memory_s"] == (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
                                   + 2 * mem["temp_size_in_bytes"]) / 3.35e12
        assert r["model_flops"] == jroofline.model_flops_per_device(
            jget_arch(r["arch"]), jget_shape(r["shape"]), 256)
    assert json.loads((tmp_path / "roofline_16x16.json").read_text()) == rows
