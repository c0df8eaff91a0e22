"""Adversarial sources for the K4 merge, made with numpy from a seed.

A helper module the test files import by name (like `_torch_parity.py`);
it imports numpy only, so the CUDA tests can use it without JAX.
"""

from __future__ import annotations

import numpy as np

INF_RANK = 2**30


def merge_sources(seed: int, n_cat: int, l_len: int):
    """(ranks, ids), each int32 (n_tiles, n_cat, L): rows sorted by rank and
    INF/-1 padded, as `build_merge_sources` gives them. One tile per case:
    all rows empty; one live entry; L - 1, L and L + 1 distinct ranks
    (count < L, = L, > L where the rows have room); 3 L distinct ranks;
    every row full of draws from a small pool (ranks repeated inside a row
    and tied across rows). Ranks are copied into other rows and within
    their own row, so ties go to the lowest row and repeats are dropped;
    every entry has its own id, so the test sees which copy was kept."""
    rng = np.random.default_rng(seed)
    cap = n_cat * l_len
    targets = [0, 1, max(l_len - 1, 0), l_len, l_len + 1, 3 * l_len]
    n_tiles = len(targets) + 1
    ranks = np.full((n_tiles, n_cat, l_len), INF_RANK, np.int64)
    for t, c in enumerate(targets):
        c = min(c, cap)
        distinct = rng.choice(20 * cap + 20, size=c, replace=False)
        rows = [[] for _ in range(n_cat)]
        extra = rng.integers(0, c // 2 + 1) if c else 0
        picks = list(distinct) + list(rng.choice(distinct, size=extra)) if c else []
        for i, r in enumerate(picks):
            room = [j for j in range(n_cat) if len(rows[j]) < l_len]
            if not room:
                break
            # copies go to a row that already holds the rank where possible
            same = [j for j in room if r in rows[j]] if i >= c else []
            rows[(same or room)[rng.integers(len(same or room))]].append(r)
        for j, row in enumerate(rows):
            ranks[t, j, :len(row)] = np.sort(row)
    pool = rng.choice(20 * cap + 20, size=max(1, cap // 3), replace=False)
    ranks[-1] = np.sort(rng.choice(pool, size=(n_cat, l_len)), axis=1)
    ids = rng.permutation(n_tiles * cap).reshape(ranks.shape)
    ids = np.where(ranks < INF_RANK, ids, -1)
    return ranks.astype(np.int32), ids.astype(np.int32)
