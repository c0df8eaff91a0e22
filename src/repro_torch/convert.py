"""Build the port's objects from numpy arrays plus plain dicts of static
metadata, on a given device.

The JAX package's objects cross into the port this way: a caller flattens
them to numpy (the parity tests do so in `tests/_torch_parity.py`), and the
functions here rebuild them as tensors, so the port never imports JAX.
Every array keeps its dtype; float arrays must already be float32, except
the LM weights of `params_from_jax`, which take the dtype of the port's
parameter (the config's, or float32 where the JAX init keeps float32).
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.binning import TileLists
from repro_torch.core.camera import Camera, StereoRig
from repro_torch.core.compression import Codec, EncodedGaussians
from repro_torch.core.gaussians import Gaussians
from repro_torch.core.lod_tree import LodTree, TreeMeta
from repro_torch.core.projection import Splats
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models import model_zoo, xlstm, zamba
from repro_torch.models.dense import DenseLM, layer_pattern

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


def _pattern_keys(pat, n_groups: int, rem) -> List[Tuple[str, Optional[int]]]:
    keys: List[Tuple[str, Optional[int]]] = [
        (f"groups/sub{si}", g) for g in range(n_groups) for si in range(len(pat))]
    return keys + [(f"rem{ri}", None) for ri in range(len(rem))]


def dense_layer_keys(cfg: ModelConfig) -> List[Tuple[str, Optional[int]]]:
    """Where each `DenseLM` layer sits in the JAX parameter and cache trees,
    in layer order: ("groups/sub{si}", g) for layer g·len(pat)+si (index g
    of the stacked leading axis), then ("rem{ri}", None)."""
    return _pattern_keys(*layer_pattern(cfg))


def xlstm_block_keys(cfg: ModelConfig) -> List[Tuple[str, Optional[int]]]:
    """As `dense_layer_keys`, for the xlstm family's blocks (`_pattern`)."""
    return _pattern_keys(*xlstm._pattern(cfg))


def jax_param_key(cfg: ModelConfig, name: str) -> Tuple[str, Optional[int]]:
    """The JAX `init` tree's '/'-joined key holding the port's parameter
    `name` (a `state_dict` key), and its index on the stacked leading axis
    (None where the JAX leaf is not stacked)."""
    parts = name.split(".")
    head, rest = parts[0], parts[2:]
    fam = cfg.family
    if head == "layers" and fam in ("dense", "vlm"):
        prefix, g = dense_layer_keys(cfg)[int(parts[1])]
        return "/".join([prefix] + rest), g
    if head == "layers" and fam == "moe":       # the routed MLP sits at the layer's top
        return "/".join(["layers"] + (rest[1:] if rest[0] == "mlp" else rest)), int(parts[1])
    if head in ("enc_layers", "dec_layers"):
        return "/".join([head] + rest), int(parts[1])
    if head == "blocks" and fam == "hybrid":
        i, k = int(parts[1]), zamba.group_size(cfg)
        return "/".join([f"groups/m{i % k}"] + rest), i // k
    if head == "blocks" and fam == "xlstm":
        prefix, g = xlstm_block_keys(cfg)[int(parts[1])]
        return "/".join([prefix] + rest), g
    return "/".join(parts), None


def params_from_jax(arrays: Arrays, cfg: ModelConfig, device: DeviceLike = None):
    """The family's model (`model_zoo.get_model(cfg).init`) holding the JAX
    `init` tree of any family. arrays: that tree flattened to numpy with
    '/'-joined keys ("embed", "groups/sub0/attn/wq", "layers/router",
    "shared/fuse", ...). Every array is used, and every parameter filled
    (`jax_param_key` maps one onto the other). bfloat16 arrays reach numpy
    as `ml_dtypes.bfloat16`, which torch does not take; they cross through
    float32, which is exact, and take the port parameter's dtype."""
    device = resolve_device(device)
    model = model_zoo.get_model(cfg).init(seed=0, device=device)
    state, used = {}, set()
    for name, t in model.state_dict().items():
        key, g = jax_param_key(cfg, name)
        a = np.asarray(arrays[key])
        used.add(key)
        a = np.array(a if g is None else a[g], dtype=np.float32)
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{name} ← {key}[{g}]: shape {a.shape}, want {tuple(t.shape)}")
        state[name] = torch.from_numpy(a).to(device=device, dtype=t.dtype)
    if set(arrays) != used:
        raise ValueError(f"JAX parameters with no place in the port: {sorted(set(arrays) - used)}")
    model.load_state_dict(state, strict=True)
    return model


def dense_params_from_jax(arrays: Arrays, cfg: ModelConfig,
                          device: DeviceLike = None) -> DenseLM:
    """A `DenseLM` holding the JAX `dense.init` tree (`params_from_jax`)."""
    return params_from_jax(arrays, cfg, device)
