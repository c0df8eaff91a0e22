"""The least time one NVIDIA H100 SXM could take for a kernel's work, from
the work these inputs need, whatever implements it: the larger of the
operations over the operation rate and the bytes over the memory rate.

Peaks (NVIDIA's data sheet, SXM part, at its 700 W limit; a share is
stated against these with the card's power limit beside it):
  HBM3: 3.35e12 bytes/s.
  float32 operations: 67e12 FLOP/s counts a fused multiply-add as two
  operations. An operation that is not fused (the program builds with
  `--fmad=false`, and a count here credits no fusion) takes one lane's issue
  slot: 132 SMs × 128 lanes × 1.98 GHz = 33.5e12 operations/s.

Each count returns (operations, bytes); `seconds` turns one or a sum of
them into the least time. Every input byte counts once, read, and every
output byte once, written."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 33.5e12

# K2: every pixel-entry a tile processes (until no pixel of it lets light
# through) computes α: dx, dy (2); the quadratic form with ½ and 2·b folded
# into the entry's conic (dx², dy², dx·dy, three products by the conic, two
# adds: 8); exp (1); × opacity (1); min with 0.99 (1); the α ≥ 1/255 test (1).
# One whose α passes also blends: T·α (1), three colour channels, a product
# and a sum each (6), T ·= 1 − α (2)
K2_ALPHA_OPS = 14
K2_BLEND_OPS = 9
K2_ENTRY_BYTES = 9 * 4      # mean (2), conic (3), colour (3), opacity: float32


def k2_needs(entries, counts, origins, tile: int, alpha_min: float = 1.0 / 255.0,
             alpha_max: float = 0.99) -> tuple:
    """(entries processed, pixel-entries processed, pixel-entries whose α
    passes) of one K2 launch's inputs: entries (n, L, 9) = mean, conic,
    colour, opacity; a tile processes its entries up to its count, in
    order, while some pixel's transmittance is above 0. The hit flags a left
    eye's launch also sets past a tile's stop are not counted."""
    import torch
    n, l_max, _ = entries.shape
    dev = entries.device
    ar = torch.arange(tile, device=dev, dtype=torch.float32) + 0.5
    px = origins[:, 0].float()[:, None, None] + ar[None, None, :]
    py = origins[:, 1].float()[:, None, None] + ar[None, :, None]
    trans = torch.ones((n, tile, tile), device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    done = passing = 0
    for i in range(min(l_max, int(counts.max()) if n else 0)):
        act = alive & (i < counts)
        if not bool(act.any()):
            break
        e = entries[:, i]
        dx, dy = px - e[:, 0, None, None], py - e[:, 1, None, None]
        power = 0.5 * (e[:, 2, None, None] * dx * dx + 2.0 * e[:, 3, None, None] * dx * dy
                       + e[:, 4, None, None] * dy * dy)
        a = torch.clamp_max(e[:, 8, None, None] * torch.exp(-power), alpha_max)
        ok = (a >= alpha_min) & act[:, None, None]
        done += int(act.sum())
        passing += int(ok.sum())
        trans = trans * (1.0 - torch.where(ok, a, 0.0))
        alive = alive & (trans.flatten(1).amax(1) > 0.0)
    return done, done * tile * tile, passing


def k2(entries: int, pixel_entries: int, passing: int, tiles: int, list_len: int,
       tile: int) -> tuple:
    """K2 (rasterize) over `tiles` tiles that processed `entries` entries
    (`pixel_entries` pixel-entries, `passing` of them past the α test):
    reads those entries, a count and an origin a tile; writes each tile's
    pixels (3 float32) and a hit flag an entry slot."""
    ops = pixel_entries * K2_ALPHA_OPS + passing * K2_BLEND_OPS
    nbytes = entries * K2_ENTRY_BYTES + tiles * (4 + 8 + tile * tile * 12 + list_len)
    return ops, nbytes


def k4(live: int, written: int, rows: int, n_cat: int, list_len: int) -> tuple:
    """K4 (the stereo merge) over `rows` right tiles, each merging `n_cat`
    depth-sorted source rows of `list_len` slots: reads every live rank
    (4 B) and the end of each source row, one id for each entry written;
    writes `list_len` ids, a count and an overflow byte a tile. One
    comparison a live rank and source row."""
    ops = live * n_cat
    nbytes = live * 4 + written * 4 + rows * (n_cat * 4 + list_len * 4 + 4 + 1)
    return ops, nbytes


def k5(rows: int, dims: int, codes: int) -> tuple:
    """K5 (nearest codeword) of `rows` rows of `dims` float32: reads the rows
    and the codebook, writes a 4-byte code a row."""
    return 0, rows * dims * 4 + rows * 4 + codes * dims * 4


# K6 per slab node: mean (12), size (4), parent (4), level (4), leaf and
# valid flags (1 + 1)
K6_NODE_BYTES = 26


def k6(pairs: int, slab: int) -> tuple:
    """K6 (the pooled slab sweep) of `pairs` (client, slab) pairs of `slab`
    nodes: reads each pair's slab, camera (12), τ (4) and root flag (1);
    writes a cut flag a node, a root flag and a float32 radius a pair."""
    return 0, pairs * (slab * K6_NODE_BYTES + 17) + pairs * (slab + 1 + 4)


def seconds(counts) -> float:
    """The least time of a list of (operations, bytes), each launch bound
    by whichever of its two is slower."""
    return sum(max(ops / OPS_PER_S, nbytes / HBM_BYTES_PER_S) for ops, nbytes in counts)
