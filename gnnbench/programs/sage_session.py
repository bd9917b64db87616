"""The program's distributed GNN training, as a user runs it: a
``RunSpec`` lowered by ``repro_torch.run.session.build_session`` (stacked
``exec.mode=vmap``), one ``Session.train_epoch`` a step.

The spec's graph and features are the benchmark's (``graph.source`` and
``graph.features`` ``gnnbench``, registered by ``gnnbench.inputs``); its
parameters and random draws are the benchmark's too. The partition is
timed by a wrapper around ``run.session.build_partition`` while the
session builds. ``build_cache`` (:func:`shared_partition`) lets
``control.py`` build the program again on the same graph's partition.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict

import numpy as np

from gnnbench import inputs


def shared_partition():
    """A ``run.session.BuildCache`` that keeps the partition for programs
    built again on one graph, but builds the graph and its features anew
    each time (the features come from the seed)."""
    from repro_torch.run import session as session_mod

    class Cache(session_mod.BuildCache):
        def graph(self, spec):
            return session_mod.build_graph(spec)

    return Cache()


def run_spec(cfg: Dict, traffic: Dict, raw: Dict, seed: int):
    from repro_torch.run.spec import RunSpec

    m = cfg["model"]
    return RunSpec.from_dict({
        "exec": {"mode": "vmap", "epochs": 1, "lr": cfg["optimizer"]["lr"]},
        "graph": {"source": inputs.SOURCE, "features": inputs.SOURCE,
                  "nodes": raw["num_nodes"], "classes": m["num_classes"],
                  "feat_dim": m["in_dim"], "norm": "mean"},
        "model": {"model": m["model"], "hidden_dim": m["hidden_dim"],
                  "num_layers": m["num_layers"], "dropout": m["dropout"],
                  "norm": m["norm"], "label_prop": m["label_prop"],
                  "lp_rate": m["lp_rate"]},
        "partition": traffic["partition"],
        "schedule": traffic["schedule"],
    }).validate()


class Program:
    def __init__(self, cfg: Dict, traffic: Dict, raw: Dict, params, draws,
                 seed: int, device, build_cache=None):
        import repro_torch.run.session as session_mod

        inputs.register_program_sources(raw)
        spec = run_spec(cfg, traffic, raw, seed)
        build_partition = session_mod.build_partition
        timed = {}

        def partition(*args, **kw):
            t0 = time.perf_counter()
            try:
                return build_partition(*args, **kw)
            finally:
                timed["s"] = time.perf_counter() - t0

        session_mod.build_partition = partition
        try:
            self.session = session_mod.build_session(spec, device=device, params=params,
                                                     randomness=draws, cache=build_cache)
        finally:
            session_mod.build_partition = build_partition
        self.partition_s = timed.get("s", 0.0)
        self.trainer = self.session.trainer
        sched = self.session.schedule
        self.cds = [s.cd for s in sched.stages]
        self.period = math.lcm(*self.cds)
        self.traced_epochs = 2 * self.period

    def epoch_kind(self) -> str:
        """``refresh`` when every delayed stage's wire runs this epoch."""
        e = self.trainer.epoch
        return "refresh" if all(e % cd == 0 for cd in self.cds) else "stale"

    def step(self) -> float:
        return self.session.train_epoch()["loss"]

    def first_moment(self):
        return self.trainer.opt_state.mu

    def params(self):
        return self.trainer.params

    @contextlib.contextmanager
    def recording(self):
        """Record the exchange of the steps run inside
        (``core.exchange.recording``): ``facts()["wire_bytes"]`` then holds
        the bytes its collectives delivered, each counted as the receiving
        worker counts it (``StepOp.wire_bytes``), over all workers."""
        from repro_torch.core import exchange

        with exchange.recording() as rec:
            yield
        self.wire_bytes = sum(o.wire_bytes() for o in rec.ops) * self.session.schedule.nparts

    def placement(self) -> Dict:
        """Where the program put its rows, as host arrays: the node each
        stacked worker row holds (``owned``, -1 on padding) and, for each
        stage whose wire quantizes, its plan's index arrays: the row each
        wire slot gathers raw, the rows summed into pre-aggregated slots,
        the wire row each received entry reads (entries of weight 0 are
        padding; the weights themselves are left out)."""
        s = self.session
        pg = s.pg
        owned = np.full((pg.nparts, pg.max_owned), -1, np.int64)
        for p, o in enumerate(pg.owned):
            owned[p, :len(o)] = o
        host = lambda v: v.detach().cpu().numpy()
        stages = {}
        for i, st in enumerate(s.schedule.stages):
            if not st.bits:
                continue
            plan = s.schedule.plan_for(st, s.wd)
            stages[i] = {"level": st.level, "gather": host(plan.send_gather_idx),
                         "gather_mask": host(plan.send_gather_mask),
                         "pre_src": host(plan.pre_src), "pre_slot": host(plan.pre_slot),
                         "pre_mask": host(plan.pre_weight) != 0,
                         "recv_row": host(plan.recv_row), "recv_dst": host(plan.recv_dst),
                         "recv_mask": host(plan.recv_weight) != 0}
        return {"owned": owned, "stages": stages}

    def facts(self) -> Dict:
        """What the metric readers count with: the session's schedule, the
        rows of its quantized wires and, once a step was recorded, the
        bytes its wire delivered."""
        s = self.session
        sched = s.schedule
        wires = []
        for st in sched.stages:
            rows = int(sched.plan_for(st, s.wd).send_gather_idx.shape[-1])
            topo = sched.topo(st)
            if topo.kind == "grouped":
                rows //= topo.shard_size
            wires.append({"level": st.level, "bits": st.bits, "cd": st.cd,
                          "rows_per_worker": rows})
        out = {"nparts": sched.nparts, "wires": wires, "partition_s": self.partition_s}
        if getattr(self, "wire_bytes", None) is not None:
            out["wire_bytes"] = self.wire_bytes
        return out

    def close(self) -> None:
        self.session.close()
        self.session = self.trainer = None
