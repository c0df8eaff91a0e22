"""xlstm-350m [ssm] — sLSTM + mLSTM blocks (6:1 pattern). [arXiv:2405.04517; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="xlstm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, slstm_every=6, mamba_expand=2,
)
