"""Training launcher on the card: the paper's distributed full-batch GCN,
and LM training for any of the ten architectures.

``--arch NAME`` trains that LM on random tokens (the port of the JAX
launcher's ``--arch`` path): ``--smoke`` takes the reduced config, without
it the full one; parameters are drawn from ``--seed`` on the device,
batches of ``--batch`` sequences of ``--seq-len`` uniform tokens from
``--seed`` + 1 (with whisper's frames and the vlm's patches as normals),
and each of ``--steps`` steps is one ``train_step`` over
``--microbatches`` micro-batches, printed as ``step i: loss x (t s)``.

Otherwise (``--gcn``, or no ``--arch``): a
:class:`repro_torch.run.RunSpec` (``--spec file.json`` + ``--set
section.field=value``; without ``--spec``, ``configs/train_products_paper``)
is lowered by ``build_session`` onto ``--device``, with all workers
stacked on that device (``exec.mode=vmap``), one process per worker
sharing it through host mailboxes (``exec.mode=multiproc``), or one
process per worker over ``torch.distributed`` collectives
(``exec.mode=shard_map``: NCCL with one card a rank, gloo on the CPU),
and trained for ``exec.epochs`` epochs. The JAX launcher's explicit flags
(``--nparts``, ``--bits``, ``--inter-cd``, ...) are accepted as aliases
onto the same spec paths (``run.cli.LEGACY_ALIASES``; ``--set`` wins over
them), as are ``--save-spec`` and ``--print-spec``; ``--set
exec.auto=tuned.json`` adopts a tuner result (``repro_torch.run.tune``).
``--ckpt-dir`` snapshots the run in the JAX package's checkpoint format
(every ``--ckpt-every`` epochs, default every epoch), ``--resume``
continues from the newest valid snapshot there, and
``repro_torch.launch.serve --set serve.ckpt=DIR`` serves the trained
parameters. LM serving is ``repro_torch.launch.serve_llm``.

``--device`` is the card by default; it raises if there is none.

Examples:
  python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke --steps 5
  python -m repro_torch.launch.train --arch granite-moe-1b-a400m --batch 8 \
      --seq-len 4096 --microbatches 4
  python -m repro_torch.launch.train --arch xlstm-350m --smoke --device cpu
  python -m repro_torch.launch.train --set exec.epochs=10
  python -m repro_torch.launch.train --spec specs/flagship_hier_int2_overlap.json \
      --set exec.mode=vmap --device cpu
  python -m repro_torch.launch.train --set exec.epochs=4 --ckpt-dir runs/products
  python -m repro_torch.launch.train --set exec.epochs=8 --ckpt-dir runs/products --resume
  python -m repro_torch.launch.train --set exec.mode=multiproc --set exec.epochs=4
  python -m repro_torch.launch.train --spec specs/shard_map.json --device cpu
  python -m repro_torch.launch.train --gcn --nparts 8 --groups 2 --inter-bits 2 --epochs 30
  python -m repro_torch.launch.train --set exec.auto=build/tuned.json
"""

from __future__ import annotations

import argparse
import time


# How each legacy flag parses, where it is not an int; ``--lp`` and
# ``--overlap`` are switches with a ``--no-`` form. ``scale`` has a spec
# path but no flag, as in the JAX launcher.
_LEGACY_KW = {
    "degree": {"type": float}, "lr": {"type": float}, "heartbeat_s": {"type": float},
    "model": {"choices": ["gcn", "sage", "gin", "gat"]},
    "strategy": {"choices": ["hybrid", "pre", "post", "vanilla"]},
    "agg_backend": {"choices": ["coo", "ell"]},
    "mode": {"choices": ["vmap", "shard_map", "multiproc"]},
    **{b: {"type": int, "choices": [0, 2, 4, 8]}
       for b in ("bits", "intra_bits", "inter_bits")},
}
_LEGACY_SWITCHES = ("lp", "overlap")
_NO_FLAG = ("scale",)


def add_legacy_args(ap: argparse.ArgumentParser) -> None:
    """The JAX launcher's historical flags, each a deprecation alias onto
    the RunSpec path(s) ``run.cli.LEGACY_ALIASES`` gives it.
    ``default=None`` means "not passed": only user-supplied values
    override the spec."""
    from repro_torch.run.cli import LEGACY_ALIASES

    for dest, paths in LEGACY_ALIASES.items():
        if dest in _NO_FLAG:
            continue
        path = "/".join((paths,) if isinstance(paths, str) else paths)
        flag = "--" + dest.replace("_", "-")
        if dest in _LEGACY_SWITCHES:
            ap.add_argument(flag, dest=dest, action="store_true", default=None,
                            help=f"alias for --set {path}=true")
            ap.add_argument(f"--no-{flag[2:]}", dest=dest, action="store_false",
                            help=f"alias for --set {path}=false")
        else:
            ap.add_argument(flag, dest=dest, default=None,
                            help=f"alias for --set {path}=...",
                            **_LEGACY_KW.get(dest, {"type": int}))


def lm_batch(cfg, batch: int, seq_len: int, gen):
    """One training batch on ``gen``'s device: ``tokens`` [B, S] uniform in
    the vocabulary, plus whisper's ``frames`` [B, enc_frames, D] and the
    vlm's ``patches`` [B, vision_patches, D] as standard normals, in that
    order of draws (the JAX launcher's law, not its values)."""
    import torch

    dev = gen.device
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq_len), generator=gen,
                                   device=dev)}
    if cfg.family == "audio":
        out["frames"] = torch.randn((batch, cfg.enc_frames, cfg.d_model), generator=gen,
                                    device=dev)
    if cfg.family == "vlm":
        if seq_len <= cfg.vision_patches:
            raise ValueError(f"{cfg.name}: --seq-len {seq_len} leaves no text after "
                             f"its {cfg.vision_patches} patches")
        out["patches"] = torch.randn((batch, cfg.vision_patches, cfg.d_model),
                                     generator=gen, device=dev)
    return out


def run_lm(args) -> None:
    import torch

    from repro_torch.configs import get_arch, get_smoke_arch
    from repro_torch.launch.serve_llm import resolve_device
    from repro_torch.models import init_params, train_step
    from repro_torch.optim import adamw_init

    dev = resolve_device(args.device)
    seed = args.seed if args.seed is not None else 0
    cfg = get_smoke_arch(args.arch) if args.smoke else get_arch(args.arch)
    params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
    opt = adamw_init(params)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    print(f"arch {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"({'reduced' if args.smoke else 'full'} config) on {dev}; batch {args.batch} x "
          f"{args.seq_len} tokens in {args.microbatches} micro-batches", flush=True)
    for i in range(args.steps):
        batch = lm_batch(cfg, args.batch, args.seq_len, gen)
        t0 = time.perf_counter()
        params, opt, loss = train_step(params, opt, batch, cfg,
                                       num_microbatches=args.microbatches)
        loss = float(loss)                  # waits for the device
        print(f"step {i}: loss {loss:.4f} ({time.perf_counter() - t0:.2f}s)", flush=True)


def main(argv=None) -> int:
    from repro_torch.run import add_spec_args, spec_from_args

    ap = argparse.ArgumentParser(
        description="Train the paper's distributed GCN from a RunSpec, or an LM (--arch)")
    ap.add_argument("--gcn", action="store_true",
                    help="the GCN trainer (the default without --arch; accepted "
                         "for the JAX launcher's command lines)")
    ap.add_argument("--arch", default=None,
                    help="train this LM architecture in place of the GCN")
    ap.add_argument("--smoke", action="store_true",
                    help="--arch: the reduced config (2 layers, narrow)")
    ap.add_argument("--steps", type=int, default=5, help="--arch: optimizer steps")
    ap.add_argument("--batch", type=int, default=4, help="--arch: sequences a step")
    ap.add_argument("--seq-len", type=int, default=128, help="--arch: tokens a sequence")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="--arch: micro-batches a step (gradient accumulation)")
    # defaults (train_products_paper) < --spec < legacy flags < --set
    add_spec_args(ap)
    add_legacy_args(ap)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    ap.add_argument("--ckpt-dir", type=str, default=None,
                    help="checkpoint directory: turns on periodic atomic "
                         "snapshots and enables --resume")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest valid checkpoint from --ckpt-dir "
                         "before training (the resumed run reproduces the "
                         "uninterrupted loss trajectory)")
    args = ap.parse_args(argv)
    if args.arch and args.gcn:
        ap.error("choose --gcn or --arch NAME")
    if args.arch:
        run_lm(args)
        return 0

    from repro_torch.configs.train_products_paper import train_products_paper
    from repro_torch.run import build_session

    spec = spec_from_args(args, base=train_products_paper())
    print(f"spec: {spec.describe()}")
    session = build_session(spec, device=args.device)
    mode, tr = spec.exec.mode, session.trainer
    g, s = session.graph, session.comm_stats()
    where = {"multiproc": f"in {spec.partition.nparts} processes on {tr.device}",
             "shard_map": (f"in {spec.partition.nparts} processes over "
                           f"{getattr(tr, 'backend', '')} on {tr.device}"),
             }.get(mode, f"stacked on {tr.device}")
    print(f"graph: {g.num_nodes} nodes, {g.num_edges} edges, "
          f"{spec.graph.classes} classes; {spec.partition.nparts} workers {where}")
    print(f"partition comm volumes: vanilla={s.vanilla} pre={s.pre} "
          f"post={s.post} hybrid={s.hybrid} (selected={s.selected})")
    p = session.partition_stats()
    print(f"partition health: cut_fraction={p['cut_fraction']:.4f} "
          f"load_imbalance={p['load_imbalance']:.3f} "
          f"agg_slot_imbalance={p['agg_slot_imbalance']:.3f} "
          f"agg_stacked_slots={p['agg_stacked_slots']} "
          f"(refine={spec.partition.refine})")
    print(f"exchange schedule: {session.schedule.describe()}")
    t0 = time.time()
    try:
        hist = session.fit(ckpt_dir=args.ckpt_dir, resume=args.resume)
        dt = time.time() - t0
        for h in hist:
            print(f"epoch {h['epoch']:4d} loss {h['loss']:.4f} "
                  f"train_acc {h['train_acc']:.4f} eval_acc {h.get('eval_acc', 0):.4f}")
        epochs = spec.exec.epochs
        print(f"trained {epochs} epochs in {dt:.1f}s "
              f"({dt / max(epochs, 1) * 1e3:.1f} ms/epoch)")
        if mode in ("multiproc", "shard_map"):
            smry = tr.summary()
            rss = [r["rss_after_slices"] for r in smry.get("ranks", [])]
            print(f"{mode}: {smry['nprocs']} procs, shared store "
                  f"{smry['store_bytes'] / 1e6:.1f} MB (one copy), "
                  f"rank RSS {[round(r / 1e6, 1) for r in rss]} MB")
    finally:
        session.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
