"""Quickstart: build a procedural city, run the LoD search, render a stereo
frame with the bit-accurate shared pipeline, and verify it against two
independent per-eye renders. Runs on the card; `--device cpu` runs the
plain PyTorch versions instead. `--out FILE` saves the stereo pair (.npy).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse
import dataclasses as dc

import numpy as np
import torch

from repro_torch.core import lod_search as ls
from repro_torch.core.camera import StereoRig, make_camera
from repro_torch.core.gaussians import CityConfig, generate_city
from repro_torch.core.lod_tree import build_lod_tree
from repro_torch.core.pipeline import render_stereo, render_stereo_reference
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="save the stereo pair here (.npy)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("== building city scene ==")
    leaves = generate_city(CityConfig(blocks_x=3, blocks_y=3, leaf_density=0.2), device=dev)
    tree = build_lod_tree(leaves, target_subtrees=32, device=dev)
    print(f"   {leaves.n} leaf gaussians → LoD tree: {tree.meta.n_real} nodes, "
          f"{tree.meta.Ns} subtrees of {tree.meta.S} slots, depth {tree.meta.depth}")

    cam = make_camera([30, 30, 1.7], [80, 80, 1.5], focal_px=300.0,
                      width=192, height=108, near=0.25, device=dev)
    rig = StereoRig(left=cam, baseline=0.06)

    print("== LoD search (fully-streaming) ==")
    cut, _state = ls.full_search(tree, cam.pos, float(cam.focal), 48.0)
    n_cut = int(cut.count())
    print(f"   cut = {n_cut} gaussians "
          f"({n_cut / tree.meta.n_real * 100:.1f}% of the scene)")

    gids, _cnt, _ovf = ls.cut_gids(cut, tree, budget=16384)
    queue = tree.gaussians.slice_rows(gids.clamp_min(0))
    queue = dc.replace(queue, opacity=torch.where(gids >= 0, queue.opacity, 0.0))

    print("== stereo rendering (shared preprocessing + triangulation) ==")
    left, right, (_s, _ll, _rl, stats) = render_stereo(
        queue, rig, tile=16, list_len=256, max_pairs=1 << 17)
    ref_l, ref_r = render_stereo_reference(queue, rig)
    exact = bool(torch.equal(left, ref_l) and torch.equal(right, ref_r))
    print(f"   bit-accurate vs independent per-eye renders: {exact}")
    print(f"   work sharing: {stats.shared_preprocess} splats preprocessed once, "
          f"{stats.right_alpha_skipped}/{stats.right_candidates} right-eye "
          f"candidates prunable via left α-checks")

    out = np.concatenate([left.cpu().numpy(), right.cpu().numpy()], axis=1)
    if args.out:
        np.save(args.out, out)
        print(f"   stereo pair saved to {args.out} (shape {out.shape})")
    else:
        print(f"   stereo pair of shape {out.shape} (pass --out FILE to save it)")
    return exact


if __name__ == "__main__":
    main()
