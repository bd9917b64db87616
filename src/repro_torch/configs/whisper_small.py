"""whisper-small [audio]: 12L(dec) + 12L(enc) d_model=768 12H (kv=12)
d_ff=3072 vocab=51865 — encoder-decoder; mel-spectrogram + conv frontend
STUBBED (input_specs supplies 1500 precomputed frame embeddings).
[arXiv:2212.04356]

long_500k is SKIPPED for this arch (30 s receptive field enc-dec model;
a 524k-token decode is architecturally meaningless — DESIGN.md §5).
"""

from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    enc_layers=12,
    enc_frames=1500,
    source="arXiv:2212.04356 (Whisper)",
)

SMOKE = ArchConfig(
    name="whisper-small-smoke",
    family="audio",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    d_ff=512,
    vocab_size=512,
    enc_layers=2,
    enc_frames=64,
    source="reduced whisper family",
)
