"""LoD tree construction + slab layout for streaming traversal.

Port of `repro.core.lod_tree`. The tree is partitioned offline at level P
into `Ns` subtrees; the top-tree (levels < P) is laid out level-major and
each subtree is a fixed-size slab of `S` nodes (BFS order, padded) whose
parent pointers are slab-local, so one thread block can sweep a slab from
shared memory. Construction is numpy on the host, seed for seed the same as
the reference; the one float32 tensor step (the parents' rotation matrices)
reproduces the reference's rounding (see `gaussians.quat_to_rotmat`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.gaussians import Gaussians, gaussians_from_numpy, quat_to_rotmat
from repro_torch.device import DeviceLike, resolve_device

K_SIGMA = 3.0  # world radius of a Gaussian = K_SIGMA * max stddev


@dataclasses.dataclass(frozen=True)
class TreeMeta:
    """Static layout metadata (python ints)."""

    T: int            # top-tree node count (levels < P)
    Ns: int           # number of subtrees
    S: int            # padded slab size
    P: int            # partition level (subtree roots live at level P)
    depth: int        # max level (root = 0)
    n_real: int       # real (non-padding) node count
    n_leaves: int
    top_level_offsets: Tuple[int, ...]  # len P+1
    slab_max_depth: int                 # max levels inside a slab (root = 0)


@dataclasses.dataclass(frozen=True)
class LodTree:
    """City-scale Gaussian LoD tree in top-tree + slab layout.

    gaussians: (N_pad,) rows [0,T) are top-tree nodes, row T + s*S + j is
               slab s local node j; padding rows are zeros.
    size:      (N_pad,) world-space bounding radius per node.
    top_parent:(T,) int32 parent within the top-tree (-1 for the root).
    top_is_leaf: (T,) bool.
    slab_parent: (Ns, S) int32 slab-local parent (-1 for the slab root).
    slab_is_leaf, slab_valid: (Ns, S) bool.
    slab_level: (Ns, S) int32 level inside the slab (padding = 2**30).
    slab_root_parent_top: (Ns,) int32 top-tree index of each slab root's parent.
    """

    gaussians: Gaussians
    size: torch.Tensor
    top_parent: torch.Tensor
    top_is_leaf: torch.Tensor
    slab_parent: torch.Tensor
    slab_is_leaf: torch.Tensor
    slab_valid: torch.Tensor
    slab_level: torch.Tensor
    slab_root_parent_top: torch.Tensor
    meta: TreeMeta

    @property
    def n_pad(self) -> int:
        return self.meta.T + self.meta.Ns * self.meta.S

    @property
    def device(self) -> torch.device:
        return self.size.device

    def slab_gid(self, s, j):
        """The global id of slab `s`'s node `j`."""
        return self.meta.T + s * self.meta.S + j

    def top_mu(self) -> torch.Tensor:
        return self.gaussians.mu[: self.meta.T]

    def top_size(self) -> torch.Tensor:
        return self.size[: self.meta.T]

    def slab_mu(self) -> torch.Tensor:
        m = self.meta
        return self.gaussians.mu[m.T:].reshape(m.Ns, m.S, 3)

    def slab_size(self) -> torch.Tensor:
        m = self.meta
        return self.size[m.T:].reshape(m.Ns, m.S)

    def valid_mask(self) -> torch.Tensor:
        """(N_pad,) bool — real nodes."""
        m = self.meta
        return torch.cat([torch.ones((m.T,), dtype=torch.bool, device=self.device),
                          self.slab_valid.reshape(-1)])

    def node_levels(self) -> torch.Tensor:
        """(N_pad,) int32 global tree depth of every padded node id (padding
        rows get a huge sentinel so they sort last)."""
        m = self.meta
        bounds = np.asarray(m.top_level_offsets[1:], np.int64)
        top = np.searchsorted(bounds, np.arange(m.T), side="right").astype(np.int32)
        top_lv = torch.as_tensor(top, device=self.device)
        slab_lv = torch.clamp_max(self.slab_level, 2**30 - m.P) + m.P
        return torch.cat([top_lv, slab_lv.reshape(-1)])

    def to(self, device) -> "LodTree":
        return dataclasses.replace(
            self, gaussians=self.gaussians.to(device),
            **{f.name: getattr(self, f.name).to(device)
               for f in dataclasses.fields(self)
               if f.name not in ("gaussians", "meta")})


# ---------------------------------------------------------------------------
# Offline construction (numpy)
# ---------------------------------------------------------------------------


def _morton_order(mu: np.ndarray, bits: int = 10) -> np.ndarray:
    """Z-order sort indices for spatial grouping."""
    lo, hi = mu.min(0), mu.max(0)
    q = ((mu - lo) / np.maximum(hi - lo, 1e-9) * ((1 << bits) - 1)).astype(np.uint64)
    code = np.zeros(mu.shape[0], np.uint64)
    for b in range(bits):
        for a in range(3):
            code |= ((q[:, a] >> np.uint64(b)) & np.uint64(1)) << np.uint64(3 * b + a)
    return np.argsort(code, kind="stable")


def _rotmat_to_quat(r: np.ndarray) -> np.ndarray:
    """Batched (M,3,3) rotation → (M,4) wxyz quaternion (numerically safe)."""
    m = r
    t = 1.0 + m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]
    q = np.zeros((r.shape[0], 4), np.float64)
    safe = t > 1e-6
    s = np.sqrt(np.where(safe, t, 1.0)) * 2
    q[safe, 0] = 0.25 * s[safe]
    q[safe, 1] = (m[safe, 2, 1] - m[safe, 1, 2]) / s[safe]
    q[safe, 2] = (m[safe, 0, 2] - m[safe, 2, 0]) / s[safe]
    q[safe, 3] = (m[safe, 1, 0] - m[safe, 0, 1]) / s[safe]
    # fallback for near-180° rotations: pick largest diagonal
    bad = ~safe
    if bad.any():
        mb = m[bad]
        i = np.argmax(np.stack([mb[:, 0, 0], mb[:, 1, 1], mb[:, 2, 2]], 1), 1)
        qb = np.zeros((mb.shape[0], 4))
        for k in range(mb.shape[0]):
            a = i[k]
            b_, c = (a + 1) % 3, (a + 2) % 3
            sk = np.sqrt(max(1.0 + mb[k, a, a] - mb[k, b_, b_] - mb[k, c, c], 1e-12)) * 2
            qb[k, 1 + a] = 0.25 * sk
            qb[k, 0] = (mb[k, c, b_] - mb[k, b_, c]) / sk
            qb[k, 1 + b_] = (mb[k, b_, a] + mb[k, a, b_]) / sk
            qb[k, 1 + c] = (mb[k, c, a] + mb[k, a, c]) / sk
        q[bad] = qb
    n = np.linalg.norm(q, axis=1, keepdims=True)
    return (q / np.maximum(n, 1e-12)).astype(np.float32)


def _merge_round(mu, log_scale, quat, opacity, sh, size, rng, b_lo, b_hi):
    """Merge consecutive groups of children into parent Gaussians (one round).

    Returns parent arrays + `group_id` per child (index of its parent)."""
    n = mu.shape[0]
    # group boundaries with random branching factor
    branches = rng.integers(b_lo, b_hi + 1, size=n)  # oversampled
    ends = np.cumsum(branches)
    m = int(np.searchsorted(ends, n))
    starts = np.concatenate([[0], ends[:m]])
    starts = starts[starts < n]
    if len(starts) == 0 or starts[0] != 0:
        starts = np.concatenate([[0], starts])
    starts = np.unique(starts)
    group_id = np.zeros(n, np.int64)
    group_id[starts[1:]] = 1
    group_id = np.cumsum(group_id)
    n_groups = int(group_id[-1]) + 1

    w = opacity * np.exp(log_scale).prod(1)  # opacity-volume weights
    w = np.maximum(w, 1e-8)
    sw = np.add.reduceat(w, starts)
    p_mu = np.add.reduceat(w[:, None] * mu, starts) / sw[:, None]

    # covariance merge: Σ_p = Σ w (Σ_c + d dᵀ) / Σ w
    rot = quat_to_rotmat(torch.from_numpy(np.ascontiguousarray(quat, np.float32))).numpy()
    sdiag = np.exp(log_scale)
    rs = rot * sdiag[:, None, :]
    cov = rs @ np.swapaxes(rs, 1, 2)
    d = mu - p_mu[group_id]
    outer = d[:, :, None] * d[:, None, :]
    p_cov = np.add.reduceat(w[:, None, None] * (cov + outer), starts) / sw[:, None, None]
    p_cov = 0.5 * (p_cov + np.swapaxes(p_cov, 1, 2))  # symmetrize
    evals, evecs = np.linalg.eigh(p_cov)
    evals = np.maximum(evals, 1e-10)
    # ensure right-handed rotation
    det = np.linalg.det(evecs)
    evecs[:, :, 0] *= np.where(det < 0, -1.0, 1.0)[:, None]
    p_quat = _rotmat_to_quat(evecs)
    p_log_scale = 0.5 * np.log(evals).astype(np.float32)

    p_opacity = (np.add.reduceat(w * opacity, starts) / sw).astype(np.float32)
    p_sh = (np.add.reduceat(w[:, None, None] * sh, starts) / sw[:, None, None]).astype(np.float32)

    # bounding-sphere union radius
    dist = np.linalg.norm(d, axis=1)
    p_size = np.maximum.reduceat(dist + size, starts).astype(np.float32)

    return (p_mu.astype(np.float32), p_log_scale, p_quat, p_opacity, p_sh, p_size,
            group_id, n_groups)


def build_lod_tree(
    leaves: Gaussians,
    *,
    branching: Tuple[int, int] = (3, 7),
    target_subtrees: int = 64,
    slab_pad_to: int = 8,
    seed: int = 0,
    device: DeviceLike = None,
) -> LodTree:
    """Agglomerate leaves bottom-up and emit the top-tree + slab layout
    (numpy, on the host; the finished tables go to `device`)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    mu = leaves.mu.cpu().numpy().astype(np.float64)
    log_scale = leaves.log_scale.cpu().numpy().astype(np.float64)
    quat = leaves.quat.cpu().numpy().astype(np.float32)
    opacity = leaves.opacity.cpu().numpy().astype(np.float64)
    sh = leaves.sh.cpu().numpy().astype(np.float64)
    n0 = mu.shape[0]
    order = _morton_order(mu.astype(np.float32))
    mu, log_scale, quat, opacity, sh = (
        mu[order], log_scale[order], quat[order], opacity[order], sh[order])
    size = (K_SIGMA * np.exp(log_scale).max(1)).astype(np.float32)

    # rounds[k] = dict of node arrays created at round k (k=0 → leaves)
    rounds = [dict(mu=mu.astype(np.float32), log_scale=log_scale.astype(np.float32),
                   quat=quat, opacity=opacity.astype(np.float32),
                   sh=sh.astype(np.float32), size=size,
                   parent_in_next=None, is_leaf=np.ones(n0, bool))]
    cur = rounds[0]
    while cur["mu"].shape[0] > 1:
        (p_mu, p_ls, p_q, p_op, p_sh, p_size, group_id, _ng) = _merge_round(
            cur["mu"].astype(np.float64), cur["log_scale"].astype(np.float64),
            cur["quat"], cur["opacity"].astype(np.float64),
            cur["sh"].astype(np.float64), cur["size"], rng, *branching)
        cur["parent_in_next"] = group_id
        nxt = dict(mu=p_mu, log_scale=p_ls, quat=p_q, opacity=p_op, sh=p_sh,
                   size=p_size, parent_in_next=None,
                   is_leaf=np.zeros(p_mu.shape[0], bool))
        rounds.append(nxt)
        cur = nxt

    n_rounds = len(rounds)
    depth = n_rounds - 1  # root level is 0, leaves at `depth`

    # ---- global node table (level = depth - round) -------------------------
    counts = [r["mu"].shape[0] for r in rounds]
    offs = np.concatenate([[0], np.cumsum(counts[::-1])])  # level-major: level 0 first
    n_real = int(offs[-1])

    def level_of_round(k):
        return depth - k

    # global index of node i in round k
    def gidx(k, i):
        lvl = level_of_round(k)
        return offs[lvl] + i

    g_mu = np.zeros((n_real, 3), np.float32)
    g_ls = np.zeros((n_real, 3), np.float32)
    g_q = np.zeros((n_real, 4), np.float32)
    g_op = np.zeros((n_real,), np.float32)
    g_sh = np.zeros((n_real,) + rounds[0]["sh"].shape[1:], np.float32)
    g_size = np.zeros((n_real,), np.float32)
    g_parent = np.full((n_real,), -1, np.int64)
    g_level = np.zeros((n_real,), np.int32)
    g_is_leaf = np.zeros((n_real,), bool)

    for k, r in enumerate(rounds):
        lvl = level_of_round(k)
        sl = slice(offs[lvl], offs[lvl] + counts[k])
        g_mu[sl] = r["mu"]
        g_ls[sl] = r["log_scale"]
        g_q[sl] = r["quat"]
        g_op[sl] = r["opacity"]
        g_sh[sl] = r["sh"]
        g_size[sl] = r["size"]
        g_level[sl] = lvl
        g_is_leaf[sl] = r["is_leaf"]
        if r["parent_in_next"] is not None:
            g_parent[sl] = offs[lvl - 1] + r["parent_in_next"]

    child_count = np.zeros(n_real, np.int64)
    np.add.at(child_count, g_parent[g_parent >= 0], 1)
    g_is_leaf = child_count == 0

    # ---- choose partition level P ------------------------------------------
    level_counts = [offs[l + 1] - offs[l] for l in range(depth + 1)]
    P = 1
    for l in range(1, depth + 1):
        if level_counts[l] >= target_subtrees or l == depth:
            P = l
            break
    P = max(1, min(P, depth))  # slab roots at level P; top-tree holds levels < P

    T = int(offs[P])
    roots = np.arange(offs[P], offs[P + 1]) if P < depth + 1 else np.array([], np.int64)
    Ns = len(roots)

    # subtree id per node (levels >= P): propagate down
    sub_of = np.full(n_real, -1, np.int64)
    sub_of[roots] = np.arange(Ns)
    for l in range(P + 1, depth + 1):
        sl = slice(offs[l], offs[l + 1])
        sub_of[sl] = sub_of[g_parent[sl]]

    # slab-local BFS order: nodes of each subtree sorted by (level, global idx)
    members = np.where(sub_of >= 0)[0]
    order2 = np.lexsort((members, g_level[members], sub_of[members]))
    members = members[order2]
    sub_sorted = sub_of[members]
    sub_starts = np.searchsorted(sub_sorted, np.arange(Ns))
    sub_counts = np.searchsorted(sub_sorted, np.arange(Ns) + 1) - sub_starts
    S_raw = int(sub_counts.max()) if Ns else 1
    S = int(np.ceil(S_raw / slab_pad_to) * slab_pad_to)

    # local index of each member node within its slab
    local_idx = np.arange(len(members)) - sub_starts[sub_sorted]
    loc_of_global = np.full(n_real, -1, np.int64)
    loc_of_global[members] = local_idx

    slab_shape = (Ns, S)
    s_mu = np.zeros(slab_shape + (3,), np.float32)
    s_ls = np.zeros(slab_shape + (3,), np.float32)
    s_q = np.zeros(slab_shape + (4,), np.float32)
    s_q[..., 0] = 1.0
    s_op = np.zeros(slab_shape, np.float32)
    s_sh = np.zeros(slab_shape + g_sh.shape[1:], np.float32)
    s_size = np.zeros(slab_shape, np.float32)
    s_parent = np.full(slab_shape, -1, np.int32)
    s_level = np.full(slab_shape, 2**30, np.int32)
    s_is_leaf = np.zeros(slab_shape, bool)
    s_valid = np.zeros(slab_shape, bool)
    root_parent_top = np.zeros(Ns, np.int32)

    rows = sub_sorted
    cols = local_idx
    s_mu[rows, cols] = g_mu[members]
    s_ls[rows, cols] = g_ls[members]
    s_q[rows, cols] = g_q[members]
    s_op[rows, cols] = g_op[members]
    s_sh[rows, cols] = g_sh[members]
    s_size[rows, cols] = g_size[members]
    s_level[rows, cols] = g_level[members] - P
    s_is_leaf[rows, cols] = g_is_leaf[members]
    s_valid[rows, cols] = True
    # slab-local parents (root keeps -1)
    par = g_parent[members]
    non_root = g_level[members] > P
    s_parent[rows[non_root], cols[non_root]] = loc_of_global[par[non_root]].astype(np.int32)
    root_parent_top[:] = g_parent[roots].astype(np.int32) if P >= 1 else -1

    slab_max_depth = int((g_level[members].max() - P) if len(members) else 0)

    # ---- pack gaussians: [top ; slabs flattened] ---------------------------
    n_pad = T + Ns * S
    f_mu = np.zeros((n_pad, 3), np.float32)
    f_ls = np.full((n_pad, 3), np.log(1e-4), np.float32)
    f_q = np.zeros((n_pad, 4), np.float32)
    f_q[:, 0] = 1.0
    f_op = np.zeros((n_pad,), np.float32)
    f_sh = np.zeros((n_pad,) + g_sh.shape[1:], np.float32)
    f_size = np.zeros((n_pad,), np.float32)

    f_mu[:T] = g_mu[:T]
    f_ls[:T] = g_ls[:T]
    f_q[:T] = g_q[:T]
    f_op[:T] = g_op[:T]
    f_sh[:T] = g_sh[:T]
    f_size[:T] = g_size[:T]
    f_mu[T:] = s_mu.reshape(-1, 3)
    f_ls[T:] = s_ls.reshape(-1, 3)
    f_q[T:] = s_q.reshape(-1, 4)
    f_op[T:] = s_op.reshape(-1)
    f_sh[T:] = s_sh.reshape((-1,) + g_sh.shape[1:])
    f_size[T:] = s_size.reshape(-1)

    # top-tree levels are 0..P-1; offs[P] == T
    top_level_offsets = tuple(int(x) for x in offs[: P + 1])

    meta = TreeMeta(
        T=T, Ns=Ns, S=S, P=P, depth=depth, n_real=n_real, n_leaves=n0,
        top_level_offsets=top_level_offsets, slab_max_depth=slab_max_depth,
    )
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return LodTree(
        gaussians=gaussians_from_numpy(f_mu, f_ls, f_q, f_op, f_sh, device),
        size=t(f_size),
        top_parent=t(g_parent[:T].astype(np.int32)),
        top_is_leaf=t(g_is_leaf[:T]),
        slab_parent=t(s_parent),
        slab_is_leaf=t(s_is_leaf),
        slab_valid=t(s_valid),
        slab_level=t(s_level),
        slab_root_parent_top=t(root_parent_top),
        meta=meta,
    )
