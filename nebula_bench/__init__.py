"""The benchmark of the PyTorch and CUDA port of Nebula (`repro_torch`)."""
