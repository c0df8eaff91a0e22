"""Build the port's objects from numpy arrays plus plain dicts of static
metadata, on a given device.

The JAX package's objects cross into the port this way: a caller flattens
them to numpy (the parity tests do so in `tests/_torch_parity.py`), and the
functions here rebuild them as tensors, so the port never imports JAX.
Every array keeps its dtype; float arrays must already be float32.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.binning import TileLists
from repro_torch.core.camera import Camera, StereoRig
from repro_torch.core.compression import Codec, EncodedGaussians
from repro_torch.core.gaussians import Gaussians
from repro_torch.core.lod_tree import LodTree, TreeMeta
from repro_torch.core.projection import Splats
from repro_torch.device import DeviceLike, resolve_device

Arrays = Mapping[str, np.ndarray]


def _t(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), device=device)


def gaussians_from_arrays(arrays: Arrays, device: DeviceLike = None) -> Gaussians:
    """keys: mu, log_scale, quat, opacity, sh."""
    device = resolve_device(device)
    return Gaussians(**{k: _t(arrays[k], device)
                        for k in ("mu", "log_scale", "quat", "opacity", "sh")})


def tree_from_arrays(arrays: Arrays, meta: Mapping, device: DeviceLike = None) -> LodTree:
    """arrays: the Gaussian fields under their own names plus size,
    top_parent, top_is_leaf, slab_parent, slab_is_leaf, slab_valid,
    slab_level, slab_root_parent_top; meta: the TreeMeta fields."""
    device = resolve_device(device)
    meta = dict(meta)
    meta["top_level_offsets"] = tuple(int(x) for x in meta["top_level_offsets"])
    return LodTree(
        gaussians=gaussians_from_arrays(arrays, device),
        **{k: _t(arrays[k], device)
           for k in ("size", "top_parent", "top_is_leaf", "slab_parent",
                     "slab_is_leaf", "slab_valid", "slab_level",
                     "slab_root_parent_top")},
        meta=TreeMeta(**meta),
    )


def camera_from_arrays(arrays: Arrays, meta: Mapping, device: DeviceLike = None) -> Camera:
    """arrays: pos (3,), rot (3,3), focal (); meta: width, height, near,
    far, cx, cy."""
    device = resolve_device(device)
    return Camera(pos=_t(arrays["pos"], device), rot=_t(arrays["rot"], device),
                  focal=_t(np.asarray(arrays["focal"], np.float32), device),
                  **dict(meta))


def rig_from_arrays(arrays: Arrays, meta: Mapping, device: DeviceLike = None) -> StereoRig:
    """The left camera's arrays/meta, plus `baseline` in meta."""
    meta = dict(meta)
    baseline = float(meta.pop("baseline"))
    return StereoRig(left=camera_from_arrays(arrays, meta, device), baseline=baseline)


def codec_from_arrays(arrays: Arrays, device: DeviceLike = None) -> Codec:
    """keys: codebook, pos_lo, pos_hi, scale_lo, scale_hi."""
    device = resolve_device(device)
    return Codec(**{k: _t(np.asarray(arrays[k]), device)
                    for k in ("codebook", "pos_lo", "pos_hi", "scale_lo", "scale_hi")})


def encoded_from_arrays(arrays: Arrays, device: DeviceLike = None) -> EncodedGaussians:
    """keys: dc, code, pos_q, scale_q, quat_q, opa_q. The uint16 fields
    become int32, as the port carries them."""
    device = resolve_device(device)
    wide = {"pos_q", "scale_q", "opa_q"}
    return EncodedGaussians(**{
        k: _t(np.asarray(arrays[k], np.int32) if k in wide else arrays[k], device)
        for k in ("dc", "code", "pos_q", "scale_q", "quat_q", "opa_q")})


def splats_from_arrays(arrays: Arrays, device: DeviceLike = None) -> Splats:
    """keys: the Splats fields."""
    device = resolve_device(device)
    return Splats(**{f: _t(arrays[f], device)
                     for f in ("mean2d", "depth", "conic", "ext", "color_l",
                               "color_r", "opacity", "disparity", "visible")})


def tile_lists_from_arrays(arrays: Arrays, meta: Mapping,
                           device: DeviceLike = None) -> TileLists:
    """arrays: lists, counts, overflow; meta: tiles_x, tiles_y."""
    device = resolve_device(device)
    return TileLists(lists=_t(arrays["lists"], device),
                     counts=_t(arrays["counts"], device),
                     overflow=_t(np.asarray(arrays["overflow"], bool), device),
                     tiles_x=int(meta["tiles_x"]), tiles_y=int(meta["tiles_y"]))
