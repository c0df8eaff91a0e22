"""Adversarial inputs for the K2 tile raster, made with numpy from a seed.

A helper module the test files import by name (like `_merge_cases.py`);
it imports numpy only, so the CUDA tests can use it without JAX.

Most tiles are built so that the entry after which the tile stops is known
without evaluating `exp`: every entry blended before the stop has α
exactly 0.99 or exactly 0 at every pixel, so each pixel's transmittance is
a product of float32(1 − 0.99) that numpy computes exactly. The tile's last
surviving pixels (one pixel, a row, a column or the whole tile, at a random
place) die at the designed entry; the other pixels die earlier, which
moves the stop from one warp to another.

At eps_t = 0 a tile stops only once T underflows to 0, and T passes
through float32's subnormal range on the way. PyTorch and the CUDA kernel
keep subnormals; XLA flushes them to zero, so the JAX reference stops
earlier. The cases give both stops.
"""

from __future__ import annotations

import numpy as np

ALPHA_MAX = np.float32(0.99)
KEEP = np.float32(1.0) - ALPHA_MAX      # T's factor under an entry of α = 0.99
FLT_MIN = np.finfo(np.float32).tiny     # the smallest normal float32
WINDOWS = (8, 16, 32)   # the kernel's window of 8 and the 16 and 32 also measured


def _times_keep(t, flush: bool):
    t = (t * KEEP).astype(np.float32)
    return np.where(t < FLT_MIN, np.float32(0.0), t) if flush else t


def killers_needed(eps_t: float, flush: bool = False) -> int:
    """Entries of α = 0.99 that take T from 1 to ≤ eps_t (float32; `flush`:
    subnormal results become 0, as in XLA)."""
    t, k = np.float32(1.0), 0
    while t > np.float32(eps_t):
        t, k = _times_keep(np.float32(t), flush), k + 1
    return k


def stop_targets(l_len: int):
    """Entries a tile should stop after: the first two, both sides of each
    window edge (W − 1, W, W + 1 and at 2W), and the last of L."""
    s = {0, 1, l_len - 1}
    for w in WINDOWS:
        s.update({w - 1, w, w + 1, 2 * w - 1, 2 * w, 2 * w + 1})
    return sorted(x for x in s if 0 <= x < l_len)


class _Tile:
    """Entries of one tile at pixel origin (ox, oy), side `tile`."""

    def __init__(self, rng, tile, ox, oy, l_len):
        self.rng, self.tile, self.ox, self.oy = rng, tile, ox, oy
        self.ent = np.zeros((l_len, 9), np.float32)     # opacity 0: α = 0
        self.cover = {}     # entry -> (tile, tile) bool: where α = 0.99 (else 0)

    def center(self, c, r):
        return self.ox + c + 0.5, self.oy + r + 0.5

    def colors(self):
        return self.rng.uniform(0.0, 1.0, 3)

    def put(self, i, mx, my, ca, cb, cc, opa, rgb=None):
        rgb = self.colors() if rgb is None else rgb
        self.ent[i] = [mx, my, ca, cb, cc, *rgb, opa]

    def killer(self, i):
        """α = 0.99 at every pixel: a wide, flat splat, opacity 2 or +inf."""
        opa = np.inf if self.rng.random() < 0.3 else 2.0
        self.put(i, *self.center(self.tile / 2, self.tile / 2), 1e-6, 0.0, 1e-6, opa)
        self.cover[i] = np.ones((self.tile, self.tile), bool)

    def all_but_column(self, i, c0):
        """α = 0.99 off column c0 and 0 on it: conic_a = −inf makes the power
        −inf where dx ≠ 0 and NaN (α = 0) where dx = 0."""
        mx, my = self.center(c0, self.tile / 2)
        self.put(i, mx, my, -np.inf, 0.0, 1e-6, 2.0)
        self.cover[i] = np.ones((self.tile, self.tile), bool)
        self.cover[i][:, c0] = False

    def all_but_row(self, i, r0):
        mx, my = self.center(self.tile / 2, r0)
        self.put(i, mx, my, 1e-6, 0.0, -np.inf, 2.0)
        self.cover[i] = np.ones((self.tile, self.tile), bool)
        self.cover[i][r0, :] = False

    def dud(self, i):
        """α = 0 at every pixel, by a NaN or +inf conic, a NaN or zero
        opacity, or a splat far from the tile."""
        mx, my = self.center(self.tile / 2, self.tile / 2)
        kind = self.rng.integers(5)
        if kind == 0:
            self.put(i, mx, my, np.nan, 0.0, 1.0, 0.8)
        elif kind == 1:
            self.put(i, mx, my, np.inf, 0.0, 1.0, 0.8)
        elif kind == 2:
            self.put(i, mx, my, 1.0, 0.0, 1.0, np.nan)
        elif kind == 3:
            self.put(i, mx, my, 1.0, 0.0, 1.0, 0.0)
        else:
            self.put(i, mx + 40 * self.tile, my, 1.0, 0.0, 1.0, 0.9)
        self.cover[i] = np.zeros((self.tile, self.tile), bool)

    def stop(self, count: int, eps_t: float, flush: bool) -> int:
        """Entries blended before the tile stops, simulated over the entries
        whose α is known; it must stop within them."""
        t = np.ones((self.tile, self.tile), np.float32)
        for i in range(min(count, len(self.ent))):
            if not t.max() > np.float32(eps_t):
                return i
            t = np.where(self.cover[i], _times_keep(t, flush), t)
        return min(count, len(self.ent))

    def splat(self, i, away_from=None):
        """A random splat with α in between, near the tile; if `away_from`
        is a pixel (c, r), its α there is 0 (power > 10 there)."""
        t = self.tile
        while True:
            c, r = self.rng.uniform(-6, t + 6, 2)
            if away_from is None or np.hypot(c - away_from[0], r - away_from[1]) >= 8.5:
                break
        s = self.rng.uniform(0.5, 1.5)
        self.put(i, self.ox + c, self.oy + r, s, self.rng.uniform(-0.2, 0.2), s,
                 self.rng.uniform(0.1, 0.95))

    def late(self, i):
        """α = 0.5 at every pixel: blended by mistake, it sets a hit."""
        self.put(i, *self.center(self.tile / 2, self.tile / 2), 1e-6, 0.0, 1e-6, 0.5)


def raster_cases(seed: int, tile: int, eps_t: float, l_len: int = 256, *,
                 in_a_row: bool = False):
    """(entries (n, L, 9) float32, counts (n,) int32, origins (n, 2) int32,
    processed (n,) int32, processed_flush (n,) int32): `processed` is the
    number of entries each tile blends before it stops, or -1 where the
    tile was not built to stop at a known entry; `processed_flush` the same
    where subnormal transmittance is flushed to 0 (XLA). Tiles: one stopping after each entry of `stop_targets`
    that eps_t allows (the survivors a pixel, a row, a column or the whole
    tile, in turn), each followed by an entry of α > 0; count 0, −1, L and
    L + 5; tiles that never stop (with count below, at and above L); and
    tiles of random splats with NaN and ±inf conics and NaN and -inf
    opacities (the killers' opacity is 2 or +inf). `in_a_row`: tile k sits
    at origin (k·tile, 0), so the tiles form one row of a tile grid (as a
    renderer that derives origins from the grid needs), built as without
    it around those origins."""
    rng = np.random.default_rng(seed)
    k = killers_needed(eps_t)
    # killers that leave T normal and above eps_t in both modes
    k_alive = killers_needed(eps_t, flush=True) - 1
    tiles, counts, processed, processed_flush = [], [], [], []

    def new_tile():
        ox, oy = (int(v) * tile for v in rng.integers(0, 128, 2))
        if in_a_row:
            ox, oy = len(tiles) * tile, 0
        tiles.append(_Tile(rng, tile, ox, oy, l_len))
        return tiles[-1]

    for n_case, s in enumerate(t for t in stop_targets(l_len) if 1.0 > eps_t):
        survivors = n_case % 4     # 0 pixel, 1 row, 2 column, 3 whole tile
        extras = {0: 2, 1: 1, 2: 1, 3: 0}[survivors]
        if s < k - 1 + extras:
            survivors, extras = 3, 0
        if s < k - 1:
            continue
        t = new_tile()
        c0, r0 = (int(v) for v in rng.integers(0, tile, 2))
        before = rng.permutation(s)           # entries 0..s-1 in random order
        for i in before[:k - 1]:
            t.killer(i)
        spare = list(before[k - 1:])
        if survivors in (0, 1):
            t.all_but_row(spare.pop(), r0)
        if survivors in (0, 2):
            t.all_but_column(spare.pop(), c0)
        for i in spare:
            t.dud(i)
        t.killer(s)
        count = l_len if rng.random() < 0.5 or s + 2 >= l_len else int(
            rng.integers(s + 2, l_len + 1))
        if s + 1 < l_len:
            t.late(s + 1)
        for i in range(s + 2, l_len):
            (t.late if rng.random() < 0.3 else t.splat)(i)
        counts.append(count)
        processed.append(t.stop(count, eps_t, flush=False))
        processed_flush.append(t.stop(count, eps_t, flush=True))
        assert processed[-1] == s + 1, (processed[-1], s)

    for count in (0, -1, l_len, l_len + 5):     # count edges, no stop inside L
        t = new_tile()
        for i in range(l_len):
            t.late(i) if i % 7 == 0 else t.splat(i)
        counts.append(count)
        processed.append(-1 if count > 0 and 1.0 > eps_t else 0)
        processed_flush.append(processed[-1])

    for count in (l_len // 2 + 3, l_len, l_len + 1):   # never stops
        t = new_tile()
        c0, r0 = (int(v) for v in rng.integers(0, tile, 2))
        slots = rng.permutation(l_len)
        for i in slots[:max(k_alive, 0)]:
            t.killer(i)
        for i in slots[max(k_alive, 0):]:
            t.dud(i) if rng.random() < 0.2 else t.splat(i, away_from=(c0, r0))
        counts.append(count)
        processed.append(min(count, l_len) if 1.0 > eps_t else 0)
        processed_flush.append(processed[-1])

    for _ in range(3):                          # random splats, some broken
        t = new_tile()
        for i in range(l_len):
            t.splat(i)
        # a conic of ±inf or NaN, an opacity of NaN or -inf: α is then 0.99
        # or 0 by IEEE rules alone (+inf opacity would make α depend on
        # where each implementation's exp underflows)
        bad = rng.random(l_len) < 0.15
        cols = rng.choice([2, 3, 4, 8], size=l_len)
        vals = np.where(cols == 8, rng.choice([np.nan, -np.inf], size=l_len),
                        rng.choice([np.nan, np.inf, -np.inf], size=l_len))
        t.ent[bad, cols[bad]] = vals[bad]
        counts.append(l_len)
        processed.append(-1 if 1.0 > eps_t else 0)
        processed_flush.append(processed[-1])

    ent = np.stack([t.ent for t in tiles])
    origins = np.array([[t.ox, t.oy] for t in tiles], np.int32)
    return (ent, np.array(counts, np.int32), origins, np.array(processed, np.int32),
            np.array(processed_flush, np.int32))
