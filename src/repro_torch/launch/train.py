"""Training launcher on the card: the paper's distributed full-batch GCN.

The port of ``repro.launch.train --gcn``: a :class:`repro_torch.run.RunSpec`
(``--spec file.json`` + ``--set section.field=value``; without ``--spec``,
``configs/train_products_paper``) is lowered by ``build_session`` onto
``--device`` (the card by default; it raises if there is none), with all
workers stacked on that device (``exec.mode=vmap``) or one process per
worker sharing it through host mailboxes (``exec.mode=multiproc``), and
trained for ``exec.epochs`` epochs. ``--ckpt-dir`` snapshots the run in the JAX
package's checkpoint format (every ``--ckpt-every`` epochs, default every
epoch), ``--resume`` continues from the newest valid snapshot there, and
``repro_torch.launch.serve --set serve.ckpt=DIR`` serves the trained
parameters. The ``--arch`` path (LM training) is not ported.

Examples:
  python -m repro_torch.launch.train --set exec.epochs=10
  python -m repro_torch.launch.train --spec specs/flagship_hier_int2_overlap.json \
      --set exec.mode=vmap --device cpu
  python -m repro_torch.launch.train --set exec.epochs=4 --ckpt-dir runs/products
  python -m repro_torch.launch.train --set exec.epochs=8 --ckpt-dir runs/products --resume
  python -m repro_torch.launch.train --set exec.mode=multiproc --set exec.epochs=4
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Train the paper's distributed GCN from a RunSpec")
    ap.add_argument("--gcn", action="store_true",
                    help="the GCN trainer (the only one ported; accepted for "
                         "the JAX launcher's command lines)")
    ap.add_argument("--spec", default=None, metavar="FILE.json",
                    help="RunSpec JSON (default: configs/train_products_paper)")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="SECTION.FIELD=VALUE", help="override one spec field")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="snapshot period in epochs; alias for "
                         "--set exec.ckpt_every=N")
    ap.add_argument("--ckpt-dir", type=str, default=None,
                    help="checkpoint directory: turns on periodic atomic "
                         "snapshots and enables --resume")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest valid checkpoint from --ckpt-dir "
                         "before training (the resumed run reproduces the "
                         "uninterrupted loss trajectory)")
    args = ap.parse_args(argv)

    from repro_torch.configs.train_products_paper import train_products_paper
    from repro_torch.run import RunSpec, build_session

    overrides = list(args.overrides)
    if args.ckpt_every is not None:
        overrides.append(f"exec.ckpt_every={args.ckpt_every}")
    spec = (RunSpec.load(args.spec).with_overrides(overrides) if args.spec
            else train_products_paper(*overrides))
    print(f"spec: {spec.describe()}")
    session = build_session(spec, device=args.device)
    multiproc = spec.exec.mode == "multiproc"
    g, s = session.graph, session.comm_stats()
    print(f"graph: {g.num_nodes} nodes, {g.num_edges} edges, "
          f"{spec.graph.classes} classes; {spec.partition.nparts} workers "
          + (f"in {spec.partition.nparts} processes on {session.trainer.device}"
             if multiproc else f"stacked on {session.trainer.device}"))
    print(f"partition comm volumes: vanilla={s.vanilla} pre={s.pre} "
          f"post={s.post} hybrid={s.hybrid} (selected={s.selected})")
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
        if multiproc:
            smry = session.trainer.summary()
            rss = [r["rss_after_slices"] for r in smry.get("ranks", [])]
            print(f"multiproc: {smry['nprocs']} procs, shared store "
                  f"{smry['store_bytes'] / 1e6:.1f} MB (one copy), "
                  f"rank RSS {[round(r / 1e6, 1) for r in rss]} MB")
    finally:
        session.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
