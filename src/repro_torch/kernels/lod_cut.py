"""K1 — the fully-streaming LoD slab sweep (paper §4.2) on Hopper, and K6 —
the same sweep over pooled (client, slab) pairs.

`lod_slab_sweep` (K1: every slab, one camera and τ) and `lod_pair_sweep`
(K6: K gathered pairs, a camera and τ each) launch the one templated kernel
of `csrc/lod_cut.cu` (one thread block per slab, the slab resident in shared
memory) for CUDA tensors, and run `slab_sweep_plain` / `pair_sweep_plain`
for CPU tensors. The plain versions are the slab-batched form of the
reference's `_slab_sweep_one` (and of its vmapped `sweep_slab_camera_pairs`):
the ground truth the kernel is held to on the card, and what the CPU tests
run.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.numerics import div_rn, fma32, sqrt_rn

_EPS_DIST = 1e-6
# The largest dynamic shared memory one block may use on the H100.
MAX_SMEM_BYTES = 232448


def slab_dist(mu: torch.Tensor, cam_pos: torch.Tensor) -> torch.Tensor:
    """‖mu − cam‖ as sqrt(fma(d2, d2, fma(d1, d1, d0·d0))): the kernel's
    order, and the rounding of the reference's compiled norm, so that
    `proj > τ` and ρ come out of the same bits on every path."""
    d = mu - cam_pos
    s = fma32(d[..., 2], d[..., 2], fma32(d[..., 1], d[..., 1], d[..., 0] * d[..., 0]))
    return sqrt_rn(s)


def slab_sweep_plain(mu, size, parent, level, is_leaf, valid, root_parent_expand,
                     cam_pos, focal, tau, *, max_depth: int):
    """Sweep (Ns, S) slabs with one camera. Returns (in_cut (Ns,S) bool,
    root_expand (Ns,) bool, rho (Ns,) float32).

    rho is the bit-accurate reuse bound min over valid nodes of
    |dist − size·focal/τ|; an all-invalid slab gets +inf."""
    dist = slab_dist(mu, cam_pos)
    gt = size * focal / torch.clamp_min(dist, _EPS_DIST) > tau

    s = mu.shape[-2]
    root = parent < 0
    pidx = parent.clamp(0, s - 1).long()
    rpe = root_parent_expand[..., None]
    expand = torch.zeros_like(gt)
    pexp = torch.zeros_like(gt)
    for lv in range(max_depth + 1):
        at = level == lv
        pe_l = torch.where(root, rpe, torch.gather(expand, -1, pidx))
        pexp = torch.where(at, pe_l, pexp)
        expand = torch.where(at, pe_l & gt, expand)
    expand = expand & valid
    in_cut = pexp & (~gt | is_leaf) & valid

    rstar = div_rn(size * focal, tau)
    margin = torch.where(valid, torch.abs(dist - rstar),
                         torch.full_like(dist, float("inf")))
    return in_cut, expand[..., 0], margin.amin(-1)


def pair_sweep_plain(mu, size, parent, level, is_leaf, valid, root_parent_expand,
                     cams, focal, taus, *, max_depth: int):
    """Sweep K (K, S) slabs, pair k at camera cams[k] (K, 3) and threshold
    taus[k] (K,). Same outputs as `slab_sweep_plain`."""
    return slab_sweep_plain(mu, size, parent, level, is_leaf, valid,
                            root_parent_expand, cams[:, None, :], focal,
                            taus[:, None], max_depth=max_depth)


def _check(fn, name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{fn}: {name} must be {dtype} {tuple(shape)} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _check_slabs(fn, mu, size, parent, level, is_leaf, valid, rpe):
    """Validate the (n, S) slab tables; returns the library and (n, S)."""
    dev = mu.device
    n, s = size.shape
    _check(fn, "mu", mu, torch.float32, (n, s, 3), dev)
    _check(fn, "size", size, torch.float32, (n, s), dev)
    _check(fn, "parent", parent, torch.int32, (n, s), dev)
    _check(fn, "level", level, torch.int32, (n, s), dev)
    _check(fn, "is_leaf", is_leaf, torch.bool, (n, s), dev)
    _check(fn, "valid", valid, torch.bool, (n, s), dev)
    _check(fn, "root_parent_expand", rpe, torch.bool, (n,), dev)
    lib = _build.library()
    smem = lib.nebula_lod_slab_sweep_smem_bytes(s)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{fn}: a slab of S={s} nodes needs {smem} B of shared "
                         f"memory, more than the {MAX_SMEM_BYTES} B a block has")
    return lib, n, s


def lod_slab_sweep(mu, size, parent, level, is_leaf, valid, root_parent_expand,
                   cam_pos, focal: float, tau: float, *, max_depth: int):
    """Sweep every slab: (in_cut (Ns,S), root_expand (Ns,), rho (Ns,)).

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    dev = mu.device
    if dev.type == "cpu":
        return slab_sweep_plain(mu, size, parent, level, is_leaf, valid,
                                root_parent_expand, cam_pos, focal, tau,
                                max_depth=max_depth)
    if dev.type != "cuda":
        raise ValueError(f"lod_slab_sweep: unsupported device {dev}")
    lib, ns, s = _check_slabs("lod_slab_sweep", mu, size, parent, level, is_leaf,
                              valid, root_parent_expand)
    _check("lod_slab_sweep", "cam_pos", cam_pos, torch.float32, (3,), dev)
    in_cut = torch.empty((ns, s), dtype=torch.bool, device=dev)
    root_expand = torch.empty((ns,), dtype=torch.bool, device=dev)
    rho = torch.empty((ns,), dtype=torch.float32, device=dev)
    if ns == 0:
        return in_cut, root_expand, rho
    p = _build.ptr
    err = lib.nebula_lod_slab_sweep(
        p(mu), p(size), p(parent), p(level), p(is_leaf), p(valid),
        p(root_parent_expand), p(cam_pos), float(focal), float(tau),
        p(in_cut), p(root_expand), p(rho), ns, s, int(max_depth),
        _build.stream_handle(dev))
    _build.check(err, "nebula_lod_slab_sweep")
    lod_slab_sweep.launches += 1
    return in_cut, root_expand, rho


lod_slab_sweep.launches = 0


def lod_pair_sweep(mu, size, parent, level, is_leaf, valid, root_parent_expand,
                   cams, focal: float, taus, *, max_depth: int):
    """Sweep K gathered (client, slab) pairs, each at its own camera (K, 3)
    and τ (K,): (in_cut (K,S), root_expand (K,), rho (K,)).

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    dev = mu.device
    if dev.type == "cpu":
        return pair_sweep_plain(mu, size, parent, level, is_leaf, valid,
                                root_parent_expand, cams, focal, taus,
                                max_depth=max_depth)
    if dev.type != "cuda":
        raise ValueError(f"lod_pair_sweep: unsupported device {dev}")
    lib, k, s = _check_slabs("lod_pair_sweep", mu, size, parent, level, is_leaf,
                             valid, root_parent_expand)
    _check("lod_pair_sweep", "cams", cams, torch.float32, (k, 3), dev)
    _check("lod_pair_sweep", "taus", taus, torch.float32, (k,), dev)
    in_cut = torch.empty((k, s), dtype=torch.bool, device=dev)
    root_expand = torch.empty((k,), dtype=torch.bool, device=dev)
    rho = torch.empty((k,), dtype=torch.float32, device=dev)
    if k == 0:
        return in_cut, root_expand, rho
    p = _build.ptr
    err = lib.nebula_lod_pair_sweep(
        p(mu), p(size), p(parent), p(level), p(is_leaf), p(valid),
        p(root_parent_expand), p(cams), p(taus), float(focal),
        p(in_cut), p(root_expand), p(rho), k, s, int(max_depth),
        _build.stream_handle(dev))
    _build.check(err, "nebula_lod_pair_sweep")
    lod_pair_sweep.launches += 1
    return in_cut, root_expand, rho


lod_pair_sweep.launches = 0
