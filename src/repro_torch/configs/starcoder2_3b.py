"""starcoder2-3b [dense]: 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE (starcoder2 uses a 4k sliding window natively).
[arXiv:2402.19173]"""

from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    rope_theta=100_000.0,
    window=4096,                 # paper-native sliding window
    source="arXiv:2402.19173 (StarCoder2)",
)

SMOKE = ArchConfig(
    name="starcoder2-3b-smoke",
    family="dense",
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    rope_theta=100_000.0,
    window=64,
    source="reduced starcoder2 family",
)
