"""repro_torch — the PyTorch/CUDA port of the Nebula collaborative-rendering
system (city-scale 3DGS LoD search on the cloud, stereo rasterization on the
client) and of its LM scaffold, written for one NVIDIA H100.

Module paths and public names mirror the JAX package `repro` one to one
(`repro_torch.core.lod_search` ↔ `repro.core.lod_search`), but nothing here
imports JAX or `repro`.

Layout:
  repro_torch.device   — device resolution (the card by default; the CPU
                         only when the caller asks for it).
  repro_torch.convert  — build port objects from numpy arrays + plain dicts.
  repro_torch.core     — scene, tree, LoD search, management tables, codec
                         fit, projection, binning, stereo merge, session.
  repro_torch.render   — the client render stages (project → bin_shared →
                         stereo_merge → rasterize).
  repro_torch.serve    — the multi-client LoD service (fleet, Δ stream,
                         snapshot/restore and journal crash recovery).
  repro_torch.checkpoint — atomic checkpoints in the reference's layout.
  repro_torch.models   — the LM family's serving path (dense: prefill and
                         cached decode); `repro_torch.configs` holds the
                         architectures.
  repro_torch.kernels  — hand-written Hopper kernels (CUDA C++, `csrc/`)
                         with their wrappers, launch counters and plain
                         PyTorch versions.
  repro_torch.tracing  — spans and counters inside a session frame and a
                         fleet sync, off by default.

Dispatch is by device: a wrapper given CUDA tensors launches its kernel (or
raises); given CPU tensors it runs the plain PyTorch version.
"""

__version__ = "0.1.0"
