"""Tile binning over the pairs a frame has, on Hopper (`csrc/binning.cu`).

`bin_tiles_kernel` runs the chain for CUDA tensors; `core.binning.bin_tiles`
calls it on the card and runs `bin_tiles_plain` for CPU tensors. The two
give the same lists, counts and overflow flag, bit for bit.

It replaces no TPU kernel: the reference bins with `jnp` sorts over the
whole (splat, tile) pair budget `max_pairs`, which the plain version
follows. At the session's budget of 2^28 pairs that took 150 device ms of a
183 ms frame (a 2^28-wide searchsorted, gathers and two stable argsorts on
int64 keys), for frames that needed 20-37% of the budget before the
precise cull. The chain's work scales with the pairs the frame has: it
counts and culls the needed pairs, emits the kept ones in depth order and
sorts only those, once, by a 16-bit tile key. Its bound on the H100 is
bytes (the source note of `csrc/binning.cu`): about 60 B a splat, the kept
pairs written once and moved by the sort's two passes (6 B a pair each
way), and the lists written once.

The sort is CUB's stable `DeviceRadixSort::SortPairs`, called from the CUDA
source on double buffers: two 8-bit passes on the 16-bit key (end_bit = the
bits of n_tiles − 1; a 32-bit key past 65536 tiles), each reading and
writing the key and a 32-bit splat id. Emitted in (depth rank, index)
order, a tile's pairs stay in that order through the stable sort, which is
the plain version's (tile, rank) order since a splat meets a tile at most
once.

The chain reads one number back: the kept total, which sizes the buffers.
Between its launches, small PyTorch ops take the sums over splats and
chunks (`emit_bases`, `exclusive_sum`, `torch.cumsum`); the fill finds each
tile's run in the sorted keys by binary search, so nothing counts pairs a
tile.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import tracing
from repro_torch.kernels import _build

PAIRS_PER_BLOCK = 2048   # csrc/binning.cu kChunk: 256 threads × 8 pair numbers
BLOCKS_PER_SM = 8        # 256-thread blocks an SM holds at once


def key_bits(n_tiles: int) -> int:
    """Bits of the sort key: those of the largest tile id, at least one."""
    return max(1, (n_tiles - 1).bit_length())


def wide_key(n_tiles: int) -> bool:
    """A 32-bit key past 65536 tiles, else 16 bits."""
    return key_bits(n_tiles) > 16


def chunk_count(max_pairs: int, m: int, n_tiles: int) -> int:
    """Chunks of pair numbers the count and emit passes can meet: the need
    is at most m·n_tiles pairs, and pairs past the budget are dropped."""
    return -(-min(max_pairs, m * n_tiles) // PAIRS_PER_BLOCK)


def exclusive_sum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum as int64."""
    x = x.long()
    return torch.cumsum(x, 0) - x


def emit_bases(kept: torch.Tensor, ranks: torch.Tensor):
    """(pos_base, kept_total) for the emit pass, from each splat's kept pair
    count and its depth rank. Splats are taken in (rank, index) order, a
    stable argsort of the ranks, so ties keep the plain version's order. A
    kept pair of splat g that is the q-th kept pair in index order goes to
    pos_base[g] + q: its splat's start among the kept pairs in (rank,
    index) order, plus its place among its splat's kept pairs."""
    kept = kept.long()
    order = torch.argsort(ranks, stable=True)
    in_rank = kept[order]
    ends = torch.cumsum(in_rank, 0)
    start = torch.empty_like(kept)
    start[order] = ends - in_rank
    total = ends[-1] if kept.numel() else torch.zeros((), dtype=torch.long, device=kept.device)
    return start - exclusive_sum(kept), total


def _check(name: str, t, dtype, shape, dev) -> None:
    if not torch.is_tensor(t) or t.dtype != dtype or tuple(t.shape) != shape:
        got = f"{t.dtype} {tuple(t.shape)}" if torch.is_tensor(t) else type(t).__name__
        raise ValueError(f"bin_tiles_kernel: {name} must be {dtype} {shape}, got {got}")
    if not t.is_contiguous():
        raise ValueError(f"bin_tiles_kernel: {name} must be contiguous")
    if t.device != dev:
        raise ValueError(f"bin_tiles_kernel: {name} is on {t.device}, mean2d on {dev}")


def bin_tiles_kernel(mean2d: torch.Tensor, ext: torch.Tensor, ranks: torch.Tensor,
                     visible: torch.Tensor, r2, *, width: int, height: int, tile: int,
                     max_pairs: int, list_len: int):
    """Per-tile depth-ordered lists of the splats (M,) on a width×height grid
    of tile-pixel tiles: (lists (n_tiles, list_len) int32, counts (n_tiles,)
    int32, overflow () bool), as `core.binning.bin_tiles_plain` gives them.
    mean2d, ext: (M, 2) float32 (ext ≥ 0 or NaN, as projection makes it);
    ranks (M,) int32; visible (M,) bool; r2 (M,) float32, the precise cull's
    radius² (`corner_r2`), or None for no cull. CUDA tensors, contiguous."""
    dev = mean2d.device if torch.is_tensor(mean2d) else None
    m = mean2d.shape[0] if torch.is_tensor(mean2d) and mean2d.dim() == 2 else -1
    for name, t, dtype, shape in (("mean2d", mean2d, torch.float32, (m, 2)),
                                  ("ext", ext, torch.float32, (m, 2)),
                                  ("ranks", ranks, torch.int32, (m,)),
                                  ("visible", visible, torch.bool, (m,))):
        _check(name, t, dtype, shape, dev)
    if r2 is not None:
        _check("r2", r2, torch.float32, (m,), dev)
    if tile < 1 or width < 1 or height < 1 or max_pairs < 0 or list_len < 0:
        raise ValueError(f"bin_tiles_kernel: tile {tile}, width {width}, height {height}, "
                         f"max_pairs {max_pairs}, list_len {list_len} out of range")
    if m >= 2**31:
        raise ValueError(f"bin_tiles_kernel: {m} splats do not fit 32-bit ids")
    if dev.type != "cuda":
        raise ValueError(f"bin_tiles_kernel: needs CUDA tensors, got {dev}")
    tiles_x, tiles_y = -(-width // tile), -(-height // tile)
    n_tiles = tiles_x * tiles_y
    lib, p, stream = _build.library(), _build.ptr, _build.stream_handle(dev)
    wide = wide_key(n_tiles)

    with tracing.span("bin.expand"):
        box = torch.empty((m, 4), dtype=torch.int32, device=dev)
        n_pairs = torch.empty((m,), dtype=torch.int64, device=dev)
        _build.check(lib.nebula_bin_spans(p(mean2d), p(ext), p(visible), p(box), p(n_pairs), m,
                                          width, height, tile, tiles_x, tiles_y, stream),
                     "nebula_bin_spans")
        offsets = torch.cumsum(n_pairs, 0)
        total = offsets[-1] if m else torch.zeros((), dtype=torch.int64, device=dev)
        tracing.count("bin.pairs_needed", total)
        tracing.count("bin.pair_budget", max_pairs)
        n_chunks = chunk_count(max_pairs, m, n_tiles)
        grid = min(n_chunks, torch.cuda.get_device_properties(dev).multi_processor_count
                   * BLOCKS_PER_SM)
        walk = (p(offsets), p(box), p(mean2d), None if r2 is None else p(r2))
        kept = torch.zeros((m,), dtype=torch.int32, device=dev)
        chunk_kept = torch.zeros((n_chunks,), dtype=torch.int32, device=dev)
        _build.check(lib.nebula_bin_count(*walk, p(kept), p(chunk_kept), m, max_pairs, tile,
                                          tiles_x, grid, stream), "nebula_bin_count")
        pos_base, kept_total = emit_bases(kept, ranks)
        chunk_base = exclusive_sum(chunk_kept)
        n_kept = int(kept_total)              # the chain's one read back to the host
        if n_kept >= 2**31:
            raise ValueError(f"bin_tiles_kernel: {n_kept} kept pairs exceed one sort")
        tracing.count("bin.pairs_sorted", n_kept)
        keys = torch.empty((2, n_kept), dtype=torch.int32 if wide else torch.int16, device=dev)
        vals = torch.empty((2, n_kept), dtype=torch.int32, device=dev)
        if n_kept:
            _build.check(lib.nebula_bin_emit(*walk, p(chunk_base), p(pos_base), p(keys),
                                             p(vals), m, max_pairs, tile, tiles_x, int(wide),
                                             grid, stream), "nebula_bin_emit")

    with tracing.span("bin.sort"):
        half = 0
        if n_kept:
            temp_bytes, selector = ctypes.c_longlong(0), ctypes.c_int(0)
            args = (p(keys), p(vals), n_kept, int(wide), key_bits(n_tiles))
            host = (ctypes.addressof(temp_bytes), ctypes.addressof(selector), stream)
            _build.check(lib.nebula_bin_sort(*args, None, *host), "nebula_bin_sort")
            temp = torch.empty((max(temp_bytes.value, 1),), dtype=torch.uint8, device=dev)
            _build.check(lib.nebula_bin_sort(*args, p(temp), *host), "nebula_bin_sort")
            half = selector.value

    with tracing.span("bin.lists"):
        lists = torch.empty((n_tiles, list_len), dtype=torch.int32, device=dev)
        counts = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        _build.check(lib.nebula_bin_fill(p(keys[half]), p(vals[half]), n_kept, p(total),
                                         max_pairs, p(lists), p(counts), p(overflow), n_tiles,
                                         list_len, int(wide), stream), "nebula_bin_fill")
    bin_tiles_kernel.launches += 1
    return lists, counts, overflow


bin_tiles_kernel.launches = 0
