"""The frozen roofline counts against hand counts at small shapes."""

import pytest
import torch

from nebula_bench import rooflines as RF


def entry(mx, my, conic, opacity):
    return [mx, my, conic, 0.0, conic, 0.5, 0.5, 0.5, opacity]


def test_k2_needs_counts_what_the_tiles_process():
    # tile 0 (2x2 pixels at the origin): a sharp splat on pixel (0, 0) whose
    # α passes there alone, then a flat one that passes at all four pixels;
    # tile 1: an opaque splat (α 1 under alpha_max 1) stops the tile, so the
    # entry after it is not processed
    entries = torch.tensor([[entry(0.5, 0.5, 100.0, 0.5), entry(1.0, 1.0, 0.0, 0.9)],
                            [entry(2.5, 0.5, 0.0, 1.0), entry(2.5, 0.5, 0.0, 0.9)]])
    counts = torch.tensor([2, 2], dtype=torch.int32)
    origins = torch.tensor([[0, 0], [2, 0]], dtype=torch.int32)
    done, pixel_entries, passing = RF.k2_needs(entries, counts, origins, tile=2,
                                               alpha_max=1.0)
    assert (done, pixel_entries, passing) == (3, 12, 1 + 4 + 4)


def test_k2_counts_without_fma_credit():
    ops, nbytes = RF.k2(entries=3, pixel_entries=12, passing=9, tiles=2, list_len=5, tile=2)
    assert ops == 12 * 14 + 9 * 9
    assert nbytes == 3 * 36 + 2 * (4 + 8 + 4 * 12 + 5)


def test_k4_counts_live_ranks_and_ids_written():
    ops, nbytes = RF.k4(live=10, written=4, rows=2, n_cat=3, list_len=8)
    assert ops == 30
    assert nbytes == 10 * 4 + 4 * 4 + 2 * (3 * 4 + 8 * 4 + 4 + 1)


def test_k5_counts_rows_and_codebook():
    assert RF.k5(rows=7, dims=9, codes=256) == (0, 7 * 36 + 7 * 4 + 256 * 36)


def test_k6_counts_pairs_of_slab_nodes():
    assert RF.k6(pairs=3, slab=8) == (0, 3 * (8 * 26 + 17) + 3 * (8 + 5))


def test_least_time_takes_the_slower_bound_of_each_launch():
    t = RF.seconds([(RF.OPS_PER_S, 0), (0, 2 * RF.HBM_BYTES_PER_S), (1.0, 1.0)])
    assert t == pytest.approx(1.0 + 2.0 + 1.0 / RF.HBM_BYTES_PER_S)
