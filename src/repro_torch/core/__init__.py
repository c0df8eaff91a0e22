"""The paper's system on PyTorch: scene and LoD tree, temporal LoD search,
Gaussian management, projection, binning, stereo merge, and the session."""
