"""seamless-m4t-medium [audio] — enc-dec backbone; audio frontend is a STUB
(precomputed frame embeddings). [arXiv:2308.11596; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=256206, head_dim=64, n_enc_layers=12, audio_downsample=4,
)
