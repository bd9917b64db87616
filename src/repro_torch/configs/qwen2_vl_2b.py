"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — M-RoPE, dynamic resolution. [arXiv:2409.12191]

Vision frontend (ViT + projector) is STUBBED per the assignment: the
language model consumes precomputed patch embeddings supplied by
``input_specs``; M-RoPE's (t, h, w) position streams are implemented.
"""

from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),   # t/h/w half-dim split (head_dim=128)
    vision_patches=256,
    source="arXiv:2409.12191 (Qwen2-VL)",
)

SMOKE = ArchConfig(
    name="qwen2-vl-2b-smoke",
    family="vlm",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    qkv_bias=True,
    head_dim=64,
    mrope_sections=(8, 12, 12),
    vision_patches=16,
    source="reduced qwen2-vl family",
)
