"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff=1408(expert)
vocab=102400 — MLA kv_lora=512, 2 shared + 64 routed experts top-6.
[arXiv:2405.04434]

Assignment header says "MoE 64e top-6"; the flavour text's "160 routed"
conflicts with the structured header and the model card (64 routed + 2
shared, top-6) — we follow the header (DESIGN.md §5).
"""

from repro_torch.models.mla import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    head_dim=128,
    rope_theta=10_000.0,
    mla=MLAConfig(num_heads=16, head_dim=128, rope_dim=64, kv_lora=512,
                  v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408, num_shared=2),
    source="arXiv:2405.04434 (DeepSeek-V2; lite variant)",
)

SMOKE = ArchConfig(
    name="deepseek-v2-lite-16b-smoke",
    family="moe",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    head_dim=64,
    mla=MLAConfig(num_heads=4, head_dim=64, rope_dim=32, kv_lora=64,
                  v_head_dim=64),
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128, num_shared=1),
    source="reduced deepseek-v2 family",
)
