"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304 — sLSTM +
mLSTM blocks (groups of 3 mLSTM + 1 sLSTM; d_ff=0: mixing blocks carry
their own up/down projections). [arXiv:2405.04517]"""

from repro_torch.models.transformer import ArchConfig
from repro_torch.models.xlstm import XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    xlstm=XLSTMConfig(d_model=1024, num_heads=4),
    xlstm_group=4,
    source="arXiv:2405.04517 (xLSTM)",
)

SMOKE = ArchConfig(
    name="xlstm-350m-smoke",
    family="ssm",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=512,
    xlstm=XLSTMConfig(d_model=256, num_heads=4, q_chunk=64, slstm_chunk=16),
    xlstm_group=2,
    source="reduced xlstm family",
)
