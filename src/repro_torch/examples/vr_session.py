"""End-to-end collaborative VR session (the paper's Fig. 9/10 workflow) on
the port.

Simulates a 90 FPS head-tracked walk through the city: the cloud runs the
temporal-aware LoD search every w frames and streams compressed Δcuts; the
client keeps its mirrored store and renders stereo frames. Reports the
bandwidth against H.265 video streaming. Runs on the card; `--device cpu`
runs the plain PyTorch versions instead.

    PYTHONPATH=src python -m repro_torch.examples.vr_session [--frames 96]
"""

import argparse
import dataclasses as dc

import numpy as np

from repro_torch.core.camera import StereoRig, TrajectoryConfig, walk_trajectory
from repro_torch.core.gaussians import CityConfig, generate_city
from repro_torch.core.lod_tree import build_lod_tree
from repro_torch.core.pipeline import CollaborativeSession, SessionConfig
from repro_torch.core.video_model import (StreamConfig, nebula_bandwidth_bps,
                                          video_bandwidth_bps)
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--render-every", type=int, default=24)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    leaves = generate_city(CityConfig(blocks_x=4, blocks_y=4, leaf_density=0.25),
                           device=dev)
    tree = build_lod_tree(leaves, target_subtrees=64, device=dev)
    print(f"scene: {tree.meta.n_real} nodes")

    rigs = []
    for cam in walk_trajectory(TrajectoryConfig(), args.frames, (200.0, 200.0),
                               focal_px=260.0, width=160, height=96, device=dev):
        rigs.append(StereoRig(left=dc.replace(cam, near=0.25), baseline=0.06))

    cfg = SessionConfig(tau=48.0, w=4, w_star=32, cut_budget=16384)
    sess = CollaborativeSession(tree, cfg, rigs[0], device=dev)

    total_bytes, resweeps, cut_sizes = 0.0, [], []
    for i, rig in enumerate(rigs):
        stats, out = sess.step(rig, render=(i % args.render_every == 0))
        total_bytes += stats.sync_bytes
        cut_sizes.append(stats.cut_size)
        if stats.synced:
            resweeps.append(stats.resweeps)
            if i < 20 or i % 24 == 0:
                print(f"frame {i:3d}: sync Δ={stats.delta_size:5d} gaussians "
                      f"{stats.sync_bytes/1024:7.1f}KiB resweeps={stats.resweeps}"
                      f" resident={stats.client_resident}")

    per_frame = total_bytes / args.frames
    nb = nebula_bandwidth_bps(per_frame * cfg.w, cfg.w, 90.0)
    video = video_bandwidth_bps(StreamConfig())  # VR res H.265 lossy-H
    print(f"\nmean cut size: {np.mean(cut_sizes):.0f}")
    print(f"mean subtree resweeps/sync: {np.mean(resweeps):.1f} "
          f"of {tree.meta.Ns} (temporal reuse)")
    print(f"bandwidth: nebula {nb/1e6:.1f} Mbps vs H.265@VR {video/1e6:.0f} Mbps "
          f"→ {nb/video*100:.1f}% (paper: 19-25%)")


if __name__ == "__main__":
    main()
