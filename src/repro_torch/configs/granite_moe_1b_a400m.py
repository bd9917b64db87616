"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base]"""

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=32, top_k=8, d_ff_expert=512, num_shared=0),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

SMOKE = ArchConfig(
    name="granite-moe-1b-a400m-smoke",
    family="moe",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128, num_shared=0),
    source="reduced granite-moe family",
)
