"""Command-line entry points of the port (`python -m repro_torch.examples.<name>`),
the counterparts of the JAX package's `examples/` scripts."""
