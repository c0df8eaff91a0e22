"""Build the port's objects from numpy arrays plus plain dicts of static
metadata, on a given device.

The JAX package's objects cross into the port this way: a caller flattens
them to numpy (the parity tests do so in `tests/_torch_parity.py`), and the
functions here rebuild them as tensors, so the port never imports JAX.
Every array keeps its dtype; float arrays must already be float32, except
the LM weights of `params_from_jax`, which take the dtype of the port's
parameter (the config's, or float32 where the JAX init keeps float32).

The LM's weights also go the other way: `params_to_jax` restacks the
port's flat layer list into JAX's scanned groups, and `stack_as_jax` /
`unstack_from_jax` carry anything keyed by parameter name (gradients, the
optimizer's moments, the compression error) with the same key map, which
is how the trainer writes JAX's checkpoint layout.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

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
from repro_torch.models.dense import layer_pattern

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


def jax_layout(names, cfg: ModelConfig) -> Dict[str, List[Tuple[str, Optional[int]]]]:
    """JAX key → the port's names that fill it, each with its index on the
    stacked leading axis (None where the JAX leaf is not stacked), in
    index order. `names`: the port's parameter names (`state_dict` keys)."""
    out: Dict[str, List[Tuple[str, Optional[int]]]] = {}
    for name in names:
        key, g = jax_param_key(cfg, name)
        out.setdefault(key, []).append((name, g))
    for key, parts in out.items():
        parts.sort(key=lambda ng: -1 if ng[1] is None else ng[1])
        if [g for _n, g in parts] not in ([None], list(range(len(parts)))):
            raise ValueError(f"{key}: the port's layers give indices {[g for _n, g in parts]}")
    return out


def stack_as_jax(named: Mapping[str, torch.Tensor], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Tensors keyed by the port's parameter names (parameters, their
    gradients or their optimizer moments) → keyed by the JAX `init` tree's
    '/'-joined keys, the per-layer tensors stacked on a leading axis as
    JAX's scanned groups hold them. Where a JAX leaf is not stacked, the
    tensor itself (no copy)."""
    out = {}
    for key, parts in jax_layout(named, cfg).items():
        ts = [named[n] for n, _g in parts]
        out[key] = ts[0] if parts[0][1] is None else torch.stack(ts)
    return out


def unstack_from_jax(arrays: Mapping[str, object], cfg: ModelConfig,
                     names) -> Dict[str, object]:
    """The inverse of `stack_as_jax` for the port's parameter `names`:
    each name's slice of its JAX leaf (tensors or numpy arrays, as given;
    a slice is a view)."""
    out = {}
    for key, parts in jax_layout(names, cfg).items():
        a = arrays[key]
        for name, g in parts:
            out[name] = a if g is None else a[g]
    return out


def axes_as_jax(axes: Mapping[str, tuple], cfg: ModelConfig) -> Dict[str, tuple]:
    """The parameters' logical axes (`layers.param_axes`, keyed by the
    port's names) keyed as the JAX `init` tree's axes, '/'-joined: a
    stacked leaf's axes gain JAX's leading "layer" (its layers' axes must
    agree)."""
    out = {}
    for key, parts in jax_layout(axes, cfg).items():
        ax = {tuple(axes[n]) for n, _g in parts}
        if len(ax) != 1:
            raise ValueError(f"{key}: the port's layers disagree on axes {sorted(ax)}")
        ax = ax.pop()
        out[key] = ax if parts[0][1] is None else ("layer",) + ax
    return out


def cache_leaf_keys(cfg: ModelConfig, cache) -> List[Tuple[Tuple, str, Optional[int]]]:
    """Where each leaf of the port's serving cache (`models/*.make_cache`)
    sits in the JAX family's cache tree: (its path in the port's cache,
    the JAX '/'-joined key, its index on the stacked leading axis)."""
    fam = cfg.family
    out: List[Tuple[Tuple, str, Optional[int]]] = [(("pos",), "pos", None)]

    def entries(group: str, prefix_of):
        for i, entry in enumerate(cache[group]):
            prefix, g = prefix_of(i)
            for name in entry:
                out.append(((group, i, name), f"{prefix}{name}", g))

    if fam in ("dense", "vlm"):
        keys = dense_layer_keys(cfg)
        entries("layers", lambda i: (keys[i][0] + "/", keys[i][1]))
    elif fam in ("moe", "encdec"):
        entries("layers", lambda i: ("", i))
    elif fam == "hybrid":
        k = zamba.group_size(cfg)
        entries("mamba", lambda i: (f"mamba/m{i % k}/", i // k))
        entries("attn", lambda i: ("attn_", i))
    elif fam == "xlstm":
        keys = xlstm_block_keys(cfg)
        entries("layers", lambda i: (keys[i][0] + "/", keys[i][1]))
    return out


def cache_as_jax(tree, cfg: ModelConfig, like=None) -> Dict[str, object]:
    """A tree in the port's cache layout, keyed as the JAX family's cache
    tree ('/'-joined): tensors stacked on JAX's leading axes, or logical
    axes with JAX's "layer" added where it stacks. `pos` becomes an int32
    scalar tensor (on the leaves' device) or (). `like`: the cache whose
    lists give the layout (`tree` itself by default)."""
    groups: Dict[str, List[Tuple[Optional[int], object]]] = {}
    for path, key, g in cache_leaf_keys(cfg, tree if like is None else like):
        leaf = tree
        for p in path:
            leaf = leaf[p]
        groups.setdefault(key, []).append((g, leaf))
    out = {}
    for key, parts in groups.items():
        parts.sort(key=lambda gl: -1 if gl[0] is None else gl[0])
        leaves = [leaf for _g, leaf in parts]
        if isinstance(leaves[0], tuple):
            if len(set(leaves)) != 1:
                raise ValueError(f"{key}: the port's layers disagree on axes {set(leaves)}")
            out[key] = leaves[0] if parts[0][0] is None else ("layer",) + leaves[0]
        elif isinstance(leaves[0], int):
            dev = next((t.device for t in _tensor_leaves(tree)), None)
            out[key] = torch.tensor(leaves[0], dtype=torch.int32, device=dev)
        else:
            out[key] = leaves[0] if parts[0][0] is None else torch.stack(leaves)
    return out


def _tensor_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensor_leaves(v)
    elif torch.is_tensor(tree):
        yield tree


def params_to_jax(model, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The inverse of `params_from_jax`: the model's parameters as the
    JAX `init` tree flattened with '/'-joined keys, pattern groups stacked.
    Arrays keep their dtype, except bfloat16, which numpy has no type for:
    it crosses as float32 (exact), and `params_from_jax` casts it back."""
    state = {n: t.detach() for n, t in model.state_dict().items()}
    return {k: (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
            for k, t in stack_as_jax(state, cfg).items()}
