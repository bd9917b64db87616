# The GCN model, the stacked halo-exchange schedule, and the single-device
# and distributed trainers in PyTorch.
from repro_torch.core.model import (
    GCNConfig,
    forward,
    init_params,
    loss_and_metrics,
    lp_masks,
)
from repro_torch.core.exchange import (
    DeviceHaloPlan,
    DeviceHierPlan,
    ExchangeSchedule,
    LayerInFlight,
    LayerProgram,
    StageSpec,
)
from repro_torch.core.randomness import GeneratorRandomness
from repro_torch.core.trainer import (
    DistConfig,
    DistributedTrainer,
    HostWorkerData,
    SingleGraphData,
    WorkerData,
    lift_worker_data,
    prepare_distributed_host,
    prepare_single,
    train_gcn_single,
)

__all__ = [
    "DeviceHaloPlan",
    "DeviceHierPlan",
    "DistConfig",
    "DistributedTrainer",
    "ExchangeSchedule",
    "GCNConfig",
    "GeneratorRandomness",
    "HostWorkerData",
    "LayerInFlight",
    "LayerProgram",
    "SingleGraphData",
    "StageSpec",
    "WorkerData",
    "forward",
    "init_params",
    "lift_worker_data",
    "loss_and_metrics",
    "lp_masks",
    "prepare_distributed_host",
    "prepare_single",
    "train_gcn_single",
]
