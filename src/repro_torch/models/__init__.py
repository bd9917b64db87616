from repro_torch.models.transformer import (
    ArchConfig,
    ServeCache,
    compute_loss,
    encode_cross_kv,
    forward_train,
    init_cache,
    init_params,
    loss_and_grads,
    serve_step,
    train_step,
)

__all__ = [
    "ArchConfig",
    "ServeCache",
    "compute_loss",
    "encode_cross_kv",
    "forward_train",
    "init_cache",
    "init_params",
    "loss_and_grads",
    "serve_step",
    "train_step",
]
