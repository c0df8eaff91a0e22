"""The scene asset: a procedural city and its LoD tree, made from a seed.

A frozen copy of the port's `core/gaussians.generate_city` and
`core/lod_tree.build_lod_tree` (numpy, on the host), so that later changes
to the program cannot move the yardstick. The city is a deployment's
offline asset, as a model's weights are: the benchmark builds it once per
run from `--seed` and hands the same arrays to the program and to the
reference. It imports nothing of the program.

`Scene.padded` is the program's layout (top-tree rows, then `Ns` slabs of
`S` rows); `Scene.parent`, `level_offsets`, `is_leaf` and `pid` are the
level-major global tree the reference searches, with `pid[g]` the padded
row of global node g.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SH_C0 = 0.28209479177387814
K_SIGMA = 3.0  # world radius of a Gaussian = K_SIGMA * max stddev


@dataclasses.dataclass(frozen=True)
class Scene:
    padded: dict             # name -> numpy array, the program's layout
    meta: dict               # T, Ns, S, P, depth, n_real, n_leaves, ...
    parent: np.ndarray       # (n_real,) int64 global parent, -1 at the root
    is_leaf: np.ndarray      # (n_real,) bool
    level_offsets: tuple     # global level l spans [off[l], off[l+1])
    pid: np.ndarray          # (n_real,) int64 padded row of each global node

    @property
    def n_pad(self) -> int:
        return self.meta["T"] + self.meta["Ns"] * self.meta["S"]


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed & (2**64 - 1), stream]))


def _surface_points(rng, n, origin, u_vec, v_vec):
    uv = rng.random((n, 2))
    return (np.asarray(origin)[None, :] + uv[:, :1] * np.asarray(u_vec)[None, :]
            + uv[:, 1:] * np.asarray(v_vec)[None, :])


def generate_city(city: dict, rng: np.random.Generator) -> dict:
    """Leaf Gaussians of the procedural city: ground splats, and five walled
    faces a block (four walls and a roof)."""
    bx_n, by_n = city["blocks_x"], city["blocks_y"]
    block, street = city["block_size"], city["street_width"]
    density, max_h = city["leaf_density"], city["max_height"]
    pitch = block + street
    ex, ey = bx_n * pitch, by_n * pitch
    pts, scales, colors = [], [], []

    def add_patch(origin, u_vec, v_vec, base_color, scale_m):
        area = np.linalg.norm(np.cross(u_vec, v_vec))
        n = max(4, int(area * density))
        pts.append(_surface_points(rng, n, origin, u_vec, v_vec))
        scales.append(np.full((n, 3), scale_m) * rng.uniform(0.6, 1.6, (n, 3)))
        colors.append(np.clip(base_color + rng.normal(0, 0.08, (n, 3)), 0.02, 0.98))

    n_ground = max(16, int(ex * ey * density * 0.08))
    gp = rng.random((n_ground, 2)) * np.array([ex, ey])
    pts.append(np.concatenate([gp, np.zeros((n_ground, 1))], axis=1))
    scales.append(np.full((n_ground, 3), 1.2) * rng.uniform(0.7, 1.4, (n_ground, 3)))
    colors.append(np.clip(0.35 + rng.normal(0, 0.05, (n_ground, 3)), 0.05, 0.9))
    for bx in range(bx_n):
        for by in range(by_n):
            x0, y0 = bx * pitch + street / 2, by * pitch + street / 2
            w = block * rng.uniform(0.5, 0.95)
            d = block * rng.uniform(0.5, 0.95)
            h = max_h * rng.uniform(0.15, 1.0)
            base = np.clip(rng.uniform(0.25, 0.8, 3), 0, 1)
            add_patch([x0, y0, 0], [w, 0, 0], [0, 0, h], base, 0.8)
            add_patch([x0, y0 + d, 0], [w, 0, 0], [0, 0, h], base * 0.9, 0.8)
            add_patch([x0, y0, 0], [0, d, 0], [0, 0, h], base * 0.95, 0.8)
            add_patch([x0 + w, y0, 0], [0, d, 0], [0, 0, h], base * 0.85, 0.8)
            add_patch([x0, y0, h], [w, 0, 0], [0, d, 0], base * 1.1, 0.8)

    mu = np.concatenate(pts, axis=0).astype(np.float32)
    scale = np.concatenate(scales, axis=0).astype(np.float32)
    col = np.concatenate(colors, axis=0).astype(np.float32)
    n = mu.shape[0]
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    opacity = rng.uniform(0.35, 0.95, n).astype(np.float32)
    k = (city["sh_degree"] + 1) ** 2
    sh = np.zeros((n, k, 3), dtype=np.float32)
    sh[:, 0, :] = (col - 0.5) / SH_C0
    if k > 1:
        protos = rng.normal(0, 0.12, (32, k - 1, 3))
        mat = rng.integers(0, 32, n)
        sh[:, 1:, :] = protos[mat] + rng.normal(0, 0.015, (n, k - 1, 3))
    return dict(mu=mu, log_scale=np.log(np.maximum(scale, 1e-4)).astype(np.float32),
                quat=quat, opacity=opacity, sh=sh)


def _morton_order(mu: np.ndarray, bits: int = 10) -> np.ndarray:
    lo, hi = mu.min(0), mu.max(0)
    q = ((mu - lo) / np.maximum(hi - lo, 1e-9) * ((1 << bits) - 1)).astype(np.uint64)
    code = np.zeros(mu.shape[0], np.uint64)
    for b in range(bits):
        for a in range(3):
            code |= ((q[:, a] >> np.uint64(b)) & np.uint64(1)) << np.uint64(3 * b + a)
    return np.argsort(code, kind="stable")


def _quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    q = q / (np.linalg.norm(q, axis=1, keepdims=True) + 1e-12)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                  2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                  2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return r.reshape(-1, 3, 3)


def _rotmat_to_quat(m: np.ndarray) -> np.ndarray:
    t = 1.0 + m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]
    q = np.zeros((m.shape[0], 4), np.float64)
    safe = t > 1e-6
    s = np.sqrt(np.where(safe, t, 1.0)) * 2
    q[safe, 0] = 0.25 * s[safe]
    q[safe, 1] = (m[safe, 2, 1] - m[safe, 1, 2]) / s[safe]
    q[safe, 2] = (m[safe, 0, 2] - m[safe, 2, 0]) / s[safe]
    q[safe, 3] = (m[safe, 1, 0] - m[safe, 0, 1]) / s[safe]
    for k in np.nonzero(~safe)[0]:   # near-180° rotations: the largest diagonal
        mb = m[k]
        a = int(np.argmax(np.diag(mb)))
        b_, c = (a + 1) % 3, (a + 2) % 3
        sk = np.sqrt(max(1.0 + mb[a, a] - mb[b_, b_] - mb[c, c], 1e-12)) * 2
        q[k] = 0.0
        q[k, 1 + a] = 0.25 * sk
        q[k, 0] = (mb[c, b_] - mb[b_, c]) / sk
        q[k, 1 + b_] = (mb[b_, a] + mb[a, b_]) / sk
        q[k, 1 + c] = (mb[c, a] + mb[a, c]) / sk
    return (q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)).astype(np.float32)


def _merge_round(mu, log_scale, quat, opacity, sh, size, rng, b_lo, b_hi):
    """Merge consecutive groups of children into parents (opacity-volume
    weighted moments). Returns the parents and each child's group."""
    n = mu.shape[0]
    ends = np.cumsum(rng.integers(b_lo, b_hi + 1, size=n))
    m = int(np.searchsorted(ends, n))
    starts = np.concatenate([[0], ends[:m]])
    starts = np.unique(np.concatenate([[0], starts[starts < n]]))
    group_id = np.zeros(n, np.int64)
    group_id[starts[1:]] = 1
    group_id = np.cumsum(group_id)

    w = np.maximum(opacity * np.exp(log_scale).prod(1), 1e-8)
    sw = np.add.reduceat(w, starts)
    p_mu = np.add.reduceat(w[:, None] * mu, starts) / sw[:, None]
    rs = _quat_to_rotmat(quat.astype(np.float32)).astype(np.float64) * np.exp(log_scale)[:, None, :]
    cov = rs @ np.swapaxes(rs, 1, 2)
    d = mu - p_mu[group_id]
    p_cov = np.add.reduceat(w[:, None, None] * (cov + d[:, :, None] * d[:, None, :]),
                            starts) / sw[:, None, None]
    p_cov = 0.5 * (p_cov + np.swapaxes(p_cov, 1, 2))
    evals, evecs = np.linalg.eigh(p_cov)
    evals = np.maximum(evals, 1e-10)
    evecs[:, :, 0] *= np.where(np.linalg.det(evecs) < 0, -1.0, 1.0)[:, None]
    p_size = np.maximum.reduceat(np.linalg.norm(d, axis=1) + size, starts)
    return dict(mu=p_mu.astype(np.float32),
                log_scale=(0.5 * np.log(evals)).astype(np.float32),
                quat=_rotmat_to_quat(evecs),
                opacity=(np.add.reduceat(w * opacity, starts) / sw).astype(np.float32),
                sh=(np.add.reduceat(w[:, None, None] * sh, starts)
                    / sw[:, None, None]).astype(np.float32),
                size=p_size.astype(np.float32)), group_id


def build_tree(leaves: dict, tree: dict, rng: np.random.Generator) -> tuple:
    """Agglomerate the leaves bottom-up; lay the tree out as a top-tree and
    `Ns` BFS-ordered slabs. Returns (padded arrays, meta, parent, is_leaf,
    level offsets, pid)."""
    b_lo, b_hi = tree["branching"]
    order = _morton_order(leaves["mu"])
    cur = {k: leaves[k][order] for k in ("mu", "log_scale", "quat", "opacity", "sh")}
    cur["size"] = (K_SIGMA * np.exp(cur["log_scale"].astype(np.float64)).max(1)).astype(np.float32)
    rounds, links = [cur], []
    while cur["mu"].shape[0] > 1:
        nxt, group_id = _merge_round(
            cur["mu"].astype(np.float64), cur["log_scale"].astype(np.float64), cur["quat"],
            cur["opacity"].astype(np.float64), cur["sh"].astype(np.float64), cur["size"],
            rng, b_lo, b_hi)
        links.append(group_id)
        rounds.append(nxt)
        cur = nxt
    depth = len(rounds) - 1
    counts = [r["mu"].shape[0] for r in rounds]
    offs = np.concatenate([[0], np.cumsum(counts[::-1])]).astype(np.int64)
    n_real = int(offs[-1])

    g = {k: np.zeros((n_real,) + rounds[0][k].shape[1:], np.float32)
         for k in ("mu", "log_scale", "quat", "opacity", "sh", "size")}
    parent = np.full(n_real, -1, np.int64)
    level = np.zeros(n_real, np.int64)
    for k, r in enumerate(rounds):
        lvl = depth - k
        sl = slice(offs[lvl], offs[lvl] + counts[k])
        for name in g:
            g[name][sl] = r[name]
        level[sl] = lvl
        if k < len(links):
            parent[sl] = offs[lvl - 1] + links[k]
    child_count = np.zeros(n_real, np.int64)
    np.add.at(child_count, parent[parent >= 0], 1)
    is_leaf = child_count == 0

    level_counts = np.diff(offs)
    P = next((l for l in range(1, depth + 1)
              if level_counts[l] >= tree["target_subtrees"] or l == depth), 1)
    P = max(1, min(P, depth))
    T = int(offs[P])
    roots = np.arange(offs[P], offs[P + 1])
    Ns = len(roots)
    sub_of = np.full(n_real, -1, np.int64)
    sub_of[roots] = np.arange(Ns)
    for l in range(P + 1, depth + 1):
        sl = slice(offs[l], offs[l + 1])
        sub_of[sl] = sub_of[parent[sl]]
    members = np.where(sub_of >= 0)[0]
    members = members[np.lexsort((members, level[members], sub_of[members]))]
    sub_sorted = sub_of[members]
    sub_starts = np.searchsorted(sub_sorted, np.arange(Ns))
    sub_counts = np.searchsorted(sub_sorted, np.arange(Ns) + 1) - sub_starts
    pad_to = tree["slab_pad_to"]
    S = int(np.ceil(int(sub_counts.max()) / pad_to) * pad_to)
    local = np.arange(len(members)) - sub_starts[sub_sorted]
    loc_of = np.full(n_real, -1, np.int64)
    loc_of[members] = local

    pid = np.arange(n_real, dtype=np.int64)
    pid[members] = T + sub_sorted * S + local
    n_pad = T + Ns * S
    padded = dict(
        mu=np.zeros((n_pad, 3), np.float32),
        log_scale=np.full((n_pad, 3), np.log(1e-4), np.float32),
        quat=np.tile(np.array([1, 0, 0, 0], np.float32), (n_pad, 1)),
        opacity=np.zeros((n_pad,), np.float32),
        sh=np.zeros((n_pad,) + g["sh"].shape[1:], np.float32),
        size=np.zeros((n_pad,), np.float32))
    for name in padded:
        padded[name][pid] = g[name]
    slab_parent = np.full((Ns, S), -1, np.int32)
    slab_level = np.full((Ns, S), 2**30, np.int32)
    slab_is_leaf = np.zeros((Ns, S), bool)
    slab_valid = np.zeros((Ns, S), bool)
    slab_level[sub_sorted, local] = level[members] - P
    slab_is_leaf[sub_sorted, local] = is_leaf[members]
    slab_valid[sub_sorted, local] = True
    non_root = level[members] > P
    slab_parent[sub_sorted[non_root], local[non_root]] = loc_of[parent[members[non_root]]]
    padded.update(top_parent=parent[:T].astype(np.int32), top_is_leaf=is_leaf[:T],
                  slab_parent=slab_parent, slab_is_leaf=slab_is_leaf,
                  slab_valid=slab_valid, slab_level=slab_level,
                  slab_root_parent_top=parent[roots].astype(np.int32))
    meta = dict(T=T, Ns=Ns, S=S, P=P, depth=depth, n_real=n_real,
                n_leaves=int(leaves["mu"].shape[0]),
                top_level_offsets=tuple(int(x) for x in offs[:P + 1]),
                slab_max_depth=int(level[members].max() - P))
    return padded, meta, parent, is_leaf, tuple(int(x) for x in offs), pid


def build_scene(config: dict, seed: int) -> Scene:
    """The configuration's city and tree, from `seed`."""
    leaves = generate_city(config["city"], _rng(seed, 0))
    padded, meta, parent, is_leaf, offs, pid = build_tree(leaves, config["tree"],
                                                          _rng(seed, 1))
    return Scene(padded=padded, meta=meta, parent=parent, is_leaf=is_leaf,
                 level_offsets=offs, pid=pid)
