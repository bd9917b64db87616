"""The program's single-device full-batch training, as
``repro_torch.core.trainer.train_gcn_single`` runs it: the graph prepared
once with ``prepare_single(..., layouts=("bucketed",))``, then one
``single_train_step`` a step (GAT: ``gat_aggregate_bucketed`` in every
layer), the loss read back at each step's end."""

from __future__ import annotations

from typing import Dict

from gnnbench import inputs


class Program:
    period = 1
    traced_epochs = 2

    def __init__(self, cfg: Dict, traffic: Dict, raw: Dict, params, draws,
                 seed: int, device, build_cache=None):
        from repro_torch.core import model as M
        from repro_torch.core.trainer import prepare_single
        from repro_torch.optim.adamw import adamw_init

        m = cfg["model"]
        self.cfg = M.GCNConfig(model=m["model"], in_dim=m["in_dim"],
                               hidden_dim=m["hidden_dim"], num_classes=m["num_classes"],
                               num_layers=m["num_layers"], dropout=m["dropout"],
                               norm=m["norm"], label_prop=m["label_prop"],
                               lp_rate=m["lp_rate"], gat_heads=m.get("heads", 4))
        self.lr = cfg["optimizer"]["lr"]
        self.data = prepare_single(inputs.make_program_graph(raw), raw["x"].copy(),
                                   norm="mean", layouts=("bucketed",), device=device)
        self.partition_s = 0.0
        self._params = params
        self.opt_state = adamw_init(params)
        self.draws = draws
        self.epoch = 0

    def epoch_kind(self) -> str:
        return "step"

    def step(self) -> float:
        from repro_torch.core.trainer import single_train_step

        self._params, self.opt_state, m = single_train_step(
            self._params, self.opt_state, self.cfg, self.data, self.draws,
            self.epoch, self.lr)
        self.epoch += 1
        return float(m["loss"])

    def first_moment(self):
        return self.opt_state.mu

    def params(self):
        return self._params

    def placement(self) -> None:
        return None

    def facts(self) -> Dict:
        return {}

    def close(self) -> None:
        self.data = self._params = self.opt_state = None
