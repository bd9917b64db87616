# AdamW and learning-rate schedules as plain functions on tensors.
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.schedule import constant_lr, cosine_lr, linear_warmup_cosine

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "constant_lr",
    "cosine_lr",
    "linear_warmup_cosine",
]
