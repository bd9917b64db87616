"""llama3.2-3b [dense]: 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256 — small llama3. [hf:meta-llama/Llama-3.2-1B family]"""

from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500_000.0,
    tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B (family card; 3B dims per assignment)",
)

SMOKE = ArchConfig(
    name="llama3.2-3b-smoke",
    family="dense",
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    rope_theta=500_000.0,
    tie_embeddings=True,
    source="reduced llama3 family",
)
