"""Hand-written Hopper kernels (CUDA C++ under `csrc/`, one shared library
built by `_build`), each beside its wrapper and its plain PyTorch version:

    K1 lod_cut.lod_slab_sweep          ← repro/kernels/lod_cut.py:lod_slab_sweep_pallas
    K2 rasterize.rasterize_slabs       ← repro/kernels/rasterize.py:rasterize_slabs_pallas
    K3 preprocess.preprocess           ← repro/kernels/preprocess.py:preprocess_pallas
    K4 stereo_shift.stereo_merge_kernel ← repro/kernels/stereo_shift.py:stereo_merge_pallas
    K5 vq_assign.vq_assign             ← repro/kernels/vq_assign.py:vq_assign_pallas
    K6 lod_cut.lod_pair_sweep          ← repro/kernels/lod_cut.py:lod_pair_sweep_pallas
    K7 flash_attention.flash_attention ← repro/kernels/flash_attention.py:flash_attention_pallas
       flash_attention.flash_attention_backward: K7's gradient (no TPU kernel: XLA
       derives the reference's)
       binning.bin_tiles_kernel: tile binning over the pairs a frame has (no TPU
       kernel: the reference bins with `jnp` sorts over the whole pair budget)

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises. One exception: `bin_tiles_kernel` takes CUDA
tensors only, and `core.binning.bin_tiles` chooses between it and the plain
version, `core.binning.bin_tiles_plain`, by the inputs' device. Each wrapper counts its launches in a plain
integer attribute, `launches`.
"""

from __future__ import annotations

from typing import Dict


def wrappers() -> Dict[str, object]:
    """name → kernel wrapper, for every kernel of the library."""
    from repro_torch.kernels.binning import bin_tiles_kernel
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_backward
    from repro_torch.kernels.lod_cut import lod_pair_sweep, lod_slab_sweep
    from repro_torch.kernels.preprocess import preprocess
    from repro_torch.kernels.rasterize import rasterize_slabs
    from repro_torch.kernels.stereo_shift import stereo_merge_kernel
    from repro_torch.kernels.vq_assign import vq_assign
    return {"lod_slab_sweep": lod_slab_sweep, "preprocess": preprocess,
            "stereo_merge": stereo_merge_kernel, "rasterize_slabs": rasterize_slabs,
            "vq_assign": vq_assign, "lod_pair_sweep": lod_pair_sweep,
            "flash_attention": flash_attention,
            "flash_attention_backward": flash_attention_backward,
            "bin_tiles": bin_tiles_kernel}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}


def reset_launch_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0
