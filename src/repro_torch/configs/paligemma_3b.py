"""paligemma-3b [vlm] — SigLIP frontend STUB (precomputed patch embeddings),
gemma backbone, prefix-LM over the image tokens. [arXiv:2407.07726; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab=257216, head_dim=256, n_img_tokens=256,
)
