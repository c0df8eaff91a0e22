"""Flatten the JAX package's objects to numpy arrays + plain dicts, and build
their `repro_torch` counterparts on the CPU through `repro_torch.convert`.

The port imports nothing of JAX; the parity tests cross between the two
packages only here, through numpy (the same pattern as
`_hypothesis_compat.py`: a helper module the test files import by name).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert

CPU = "cpu"


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch on one thread for a module's tests: the small eager ops of a
    training step lose more to six workers' threads contending for the
    cores than they gain from intra-op threads (a test file imports this
    fixture and marks its tests with `usefixtures`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

GAUSSIAN_FIELDS = ("mu", "log_scale", "quat", "opacity", "sh")
TREE_FIELDS = ("size", "top_parent", "top_is_leaf", "slab_parent", "slab_is_leaf",
               "slab_valid", "slab_level", "slab_root_parent_top")
SPLAT_FIELDS = ("mean2d", "depth", "conic", "ext", "color_l", "color_r", "opacity",
                "disparity", "visible")


def np_(x) -> np.ndarray:
    """A JAX array or a torch tensor as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def gaussians_arrays(g) -> dict:
    return {k: np_(getattr(g, k)) for k in GAUSSIAN_FIELDS}


def tree_arrays(tree):
    arrays = gaussians_arrays(tree.gaussians)
    arrays.update({k: np_(getattr(tree, k)) for k in TREE_FIELDS})
    return arrays, dataclasses.asdict(tree.meta)


def camera_arrays(cam):
    arrays = {"pos": np_(cam.pos), "rot": np_(cam.rot), "focal": np_(cam.focal)}
    meta = {k: getattr(cam, k) for k in ("width", "height", "near", "far", "cx", "cy")}
    return arrays, meta


def saturating_scene(n_front: int, n_back: int, seed: int) -> dict:
    """Gaussian arrays (`GAUSSIAN_FIELDS`, SH degree 1) seen from (33, 33,
    1.7) toward (40, 40, 1.5), at focal 200 and 96x64 pixels: a front layer
    of large Gaussians of opacity 0.99 around (36.5, 36.5, 1.6), and small
    ones behind it in a 6 m cube around (40, 40, 1.5). Every pixel's
    transmittance underflows to 0 within the first few dozen entries of
    most tiles, so those tiles stop early, and the small Gaussians behind
    come after the stop in every tile that lists them."""
    rng = np.random.default_rng(seed)
    n = n_front + n_back
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True) + 1e-12
    front = rng.uniform(-1.0, 1.0, (n_front, 3)) + [36.5, 36.5, 1.6]
    back = rng.uniform(-3.0, 3.0, (n_back, 3)) + [40.0, 40.0, 1.5]
    scale = np.concatenate([rng.uniform(2.0, 4.0, (n_front, 3)),
                            rng.uniform(0.1, 0.3, (n_back, 3))])
    opacity = np.concatenate([np.full(n_front, 0.99), rng.uniform(0.5, 0.99, n_back)])
    return {"mu": np.concatenate([front, back]).astype(np.float32),
            "log_scale": np.log(scale).astype(np.float32), "quat": quat,
            "opacity": opacity.astype(np.float32),
            "sh": rng.normal(0, 0.35, (n, 4, 3)).astype(np.float32)}


def to_torch_gaussians(g):
    return convert.gaussians_from_arrays(gaussians_arrays(g), CPU)


def to_torch_tree(tree):
    return convert.tree_from_arrays(*tree_arrays(tree), device=CPU)


def to_torch_camera(cam):
    return convert.camera_from_arrays(*camera_arrays(cam), device=CPU)


def to_torch_rig(rig):
    arrays, meta = camera_arrays(rig.left)
    return convert.rig_from_arrays(arrays, {**meta, "baseline": rig.baseline}, CPU)


def to_torch_splats(s):
    return convert.splats_from_arrays({k: np_(getattr(s, k)) for k in SPLAT_FIELDS}, CPU)


def to_torch_tile_lists(tl):
    return convert.tile_lists_from_arrays(
        {"lists": np_(tl.lists), "counts": np_(tl.counts), "overflow": np_(tl.overflow)},
        {"tiles_x": tl.tiles_x, "tiles_y": tl.tiles_y}, CPU)


def to_torch_codec(codec):
    return convert.codec_from_arrays(
        {k: np_(getattr(codec, k)) for k in ("codebook", "pos_lo", "pos_hi",
                                             "scale_lo", "scale_hi")}, CPU)


def assert_equal(a, b, msg=""):
    np.testing.assert_array_equal(np_(a), np_(b), err_msg=msg)


def assert_close(a, b, rtol, atol, msg=""):
    np.testing.assert_allclose(np_(a), np_(b), rtol=rtol, atol=atol, err_msg=msg)


def flatten_tree(tree, prefix: str = "") -> dict:
    """A nested dict of arrays (a JAX parameter or cache tree) as
    {'a/b/c': numpy array}, the form `convert.params_from_jax` takes."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(flatten_tree(val, path + "/"))
        else:
            out[path] = np_(val)
    return out


def randomize_constants(tree, rng):
    """A JAX parameter tree with seeded values in the leaves its `init`
    leaves constant: norm scales (1 + 0.2·N), QKV biases (0.5·N), and
    Mamba2's A_log, dt_bias (0.5·N) and D (1 + 0.2·N)."""
    import jax.numpy as jnp
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = randomize_constants(val, rng)
        elif key in ("bq", "bk", "bv", "A_log", "dt_bias"):
            out[key] = jnp.asarray(0.5 * rng.normal(size=val.shape), val.dtype)
        elif key.endswith("norm") or key == "D":
            out[key] = jnp.asarray(1.0 + 0.2 * rng.normal(size=val.shape), val.dtype)
        else:
            out[key] = val
    return out


def to_torch_model(params, cfg):
    """Any family's JAX `init` tree as the port's model on the CPU."""
    return convert.params_from_jax(flatten_tree(params), cfg, CPU)


def dense_cache_layers(cache, cfg) -> list:
    """The JAX dense cache's per-layer {'k', 'v'} numpy arrays in layer order
    (the port's `cache['layers']` order)."""
    flat = flatten_tree(cache)
    out = []
    for prefix, g in convert.dense_layer_keys(cfg):
        kv = {n: flat[f"{prefix}/{n}"] for n in ("k", "v")}
        out.append({n: a if g is None else a[g] for n, a in kv.items()})
    return out


def port_cache_from_jax(cache, cfg) -> dict:
    """A JAX serving cache of any family as numpy arrays in the port's
    layout (`models/*.make_cache`): per-layer entries unstacked from the
    JAX leading axes into lists in layer order, `pos` an int."""
    flat = flatten_tree(cache)
    out = {"pos": int(flat.pop("pos"))}
    fam = cfg.family

    def at(prefix, g, names):
        return {n: flat[f"{prefix}/{n}"] if g is None else flat[f"{prefix}/{n}"][g]
                for n in names}

    if fam in ("dense", "vlm"):
        out["layers"] = [at(p_, g, ("k", "v")) for p_, g in convert.dense_layer_keys(cfg)]
    elif fam in ("moe", "encdec"):
        names = ("k", "v") if fam == "moe" else ("k", "v", "ck", "cv")
        out["layers"] = [{n: flat[n][i] for n in names} for i in range(cfg.n_layers)]
    elif fam == "hybrid":
        k = cfg.attn_every or cfg.n_layers
        out["mamba"] = [at(f"mamba/m{i % k}", i // k, ("ssd", "conv"))
                        for i in range(cfg.n_layers)]
        out["attn"] = [{"k": flat["attn_k"][g], "v": flat["attn_v"][g]}
                       for g in range(cfg.n_layers // k)]
    elif fam == "xlstm":
        out["layers"] = []
        for prefix, g in convert.xlstm_block_keys(cfg):
            names = sorted(n.rsplit("/", 1)[1] for n in flat if n.startswith(prefix + "/"))
            out["layers"].append(at(prefix, g, names))
    return out


def assert_cache_close(ours, theirs: dict, rtol: float, atol: float, ctx: str = "",
                       of_largest: bool = False) -> None:
    """The port's cache against `port_cache_from_jax`'s: the same structure,
    `pos` equal, every leaf of the same shape and within tolerance; with
    `of_largest`, within `atol` times the leaf's largest |value| instead."""
    if isinstance(theirs, dict):
        assert isinstance(ours, dict) and sorted(ours) == sorted(theirs), (ctx, sorted(ours))
        for key in theirs:
            assert_cache_close(ours[key], theirs[key], rtol, atol, f"{ctx}/{key}", of_largest)
    elif isinstance(theirs, list):
        assert isinstance(ours, list) and len(ours) == len(theirs), ctx
        for i, (a, b) in enumerate(zip(ours, theirs)):
            assert_cache_close(a, b, rtol, atol, f"{ctx}[{i}]", of_largest)
    elif isinstance(theirs, int):
        assert ours == theirs, (ctx, ours, theirs)
    else:
        assert tuple(ours.shape) == theirs.shape, (ctx, tuple(ours.shape), theirs.shape)
        if of_largest:
            rtol, atol = 0.0, atol * float(np.abs(theirs).max())
        assert_close(ours, theirs, rtol, atol, ctx)


def state_arrays(obj, prefix: str = "") -> dict:
    """{field path: numpy array} over a (JAX or port) dataclass of arrays,
    such as a service's state or its stats."""
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(state_arrays(getattr(obj, f.name), f"{prefix}{f.name}/"))
        return out
    return {prefix.rstrip("/"): np_(obj)}


def assert_states_equal(ours, theirs, ctx: str = "") -> None:
    """Every leaf of two dataclasses of arrays equal, dtypes included (a
    float leaf bit for bit)."""
    a, b = state_arrays(ours), state_arrays(theirs)
    assert a.keys() == b.keys(), ctx
    for k in b:
        assert a[k].dtype == b[k].dtype, f"{ctx}: {k} {a[k].dtype} vs {b[k].dtype}"
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{ctx}: {k}")
