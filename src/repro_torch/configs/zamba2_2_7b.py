"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention block
applied every 6th layer (shared weights, per-application KV cache).
[arXiv:2411.15242]"""

from repro_torch.models.mamba2 import MambaConfig
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    rope_theta=10_000.0,
    mamba=MambaConfig(d_inner=5120, head_dim=64, state_dim=64),
    attn_every=6,
    source="arXiv:2411.15242 (Zamba2)",
)

SMOKE = ArchConfig(
    name="zamba2-2.7b-smoke",
    family="hybrid",
    num_layers=4,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    d_ff=512,
    vocab_size=512,
    mamba=MambaConfig(d_inner=512, head_dim=64, state_dim=32, chunk=32),
    attn_every=2,
    source="reduced zamba2 family",
)
