"""LM-family architecture zoo: the dense decoder family's serving path
(`dense.prefill`, `dense.decode_step`) through `model_zoo.get_model`.
Self-attention over the whole prompt runs kernel K7
(`kernels/flash_attention.py`) on the card."""
