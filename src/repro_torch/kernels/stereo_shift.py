"""K4 — the SRU line-buffer k-way merge (paper §5) on Hopper.

`stereo_merge_kernel` launches `csrc/stereo_shift.cu` (one block per right-eye
tile: the tile's rows staged in shared memory, pairwise merge-path rounds,
a block-wide scan for the emits) for CUDA tensors and runs
`stereo_merge_plain` for CPU tensors. Inputs are the n_cat rank-sorted,
INF_RANK-padded source rows of every right tile (`core.stereo.
build_merge_sources`); the merge repeatedly takes the smallest head rank
(the lowest row wins a tie), emits its id unless the rank repeats the
previous one (the same splat seen from two columns), and counts emits past
the list capacity without writing them.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

INF_RANK = 2**30
MAX_SMEM_BYTES = 232448  # a block's shared memory on the H100 (a tile takes
                         # 12·n_cat·L bytes, so n_cat·L also fits 16-bit indices)


def stereo_merge_plain(src_ranks: torch.Tensor, src_ids: torch.Tensor):
    """Sort-based merge: stable sort by rank, drop INF and duplicates.
    Returns (ids (n, L) int32, count (n,) int32 untruncated, overflow (n,))."""
    n_tiles, n_cat, l_len = src_ranks.shape
    r = src_ranks.reshape(n_tiles, -1)
    g = src_ids.reshape(n_tiles, -1)
    order = torch.argsort(r, dim=1, stable=True)
    sr = torch.gather(r, 1, order)
    sg = torch.gather(g, 1, order)
    dup = torch.zeros_like(sr, dtype=torch.bool)
    dup[:, 1:] = sr[:, 1:] == sr[:, :-1]
    keep = (sr < INF_RANK) & ~dup
    pos = torch.arange(sr.shape[1], device=sr.device)[None, :].expand_as(sr)
    comp_order = torch.argsort(torch.where(keep, pos, torch.full_like(pos, INF_RANK)),
                               dim=1, stable=True)
    out = torch.gather(torch.where(keep, sg, torch.full_like(sg, -1)), 1, comp_order)
    count = keep.sum(1).to(torch.int32)
    return out[:, :l_len].to(torch.int32).contiguous(), count, count > l_len


def stereo_merge_kernel(src_ranks: torch.Tensor, src_ids: torch.Tensor):
    """Merge every right tile's source rows: (ids (n, L), count (n,),
    overflow (n,)). CPU tensors run the plain version; CUDA tensors launch K4."""
    dev = src_ranks.device
    if dev.type == "cpu":
        return stereo_merge_plain(src_ranks, src_ids)
    if dev.type != "cuda":
        raise ValueError(f"stereo_merge_kernel: unsupported device {dev}")
    n_tiles, n_cat, l_len = src_ranks.shape
    for name, t in (("src_ranks", src_ranks), ("src_ids", src_ids)):
        if t.dtype != torch.int32 or tuple(t.shape) != (n_tiles, n_cat, l_len) \
                or t.device != dev:
            raise ValueError(f"stereo_merge_kernel: {name} must be int32 "
                             f"{(n_tiles, n_cat, l_len)} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"stereo_merge_kernel: {name} must be contiguous")
    if n_cat < 1 or l_len < 1:
        raise ValueError(f"stereo_merge_kernel: empty source rows ({n_cat} x {l_len})")
    lib = _build.library()
    smem = lib.nebula_stereo_merge_smem_bytes(n_cat, l_len)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"stereo_merge_kernel: {n_cat} rows of {l_len} need {smem} B of "
                         f"shared memory, more than the {MAX_SMEM_BYTES} B a block has")
    out = torch.empty((n_tiles, l_len), dtype=torch.int32, device=dev)
    count = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    overflow = torch.empty((n_tiles,), dtype=torch.bool, device=dev)
    if n_tiles > 0:
        p = _build.ptr
        err = lib.nebula_stereo_merge(p(src_ranks), p(src_ids), p(out), p(count),
                                      p(overflow), n_tiles, n_cat, l_len,
                                      _build.stream_handle(dev))
        _build.check(err, "nebula_stereo_merge")
        stereo_merge_kernel.launches += 1
    return out, count, overflow


stereo_merge_kernel.launches = 0
