"""tinyllama-1.1b [dense]: 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000 — llama2-arch small. [arXiv:2401.02385]"""

from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    rope_theta=10_000.0,
    source="arXiv:2401.02385 (TinyLlama)",
)

SMOKE = ArchConfig(
    name="tinyllama-1.1b-smoke",
    family="dense",
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    rope_theta=10_000.0,
    source="reduced tinyllama family",
)
