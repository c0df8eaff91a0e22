"""Batched multi-client cloud session (the paper's Fig. 9 cloud, B headsets)
on the port.

One shared city tree and codec serve a fleet of head-tracked clients: each
client's temporal LoD search runs with its own foveated τ, and the stale
subtrees of all clients are pooled into one bucketed sweep
(`repro_torch.serve.lod_service`). After the session, the cloud renders a
stereo frame of every client for the fallback tier, headsets too weak to
rasterize locally. Prints a per-client accounting table and the fleet's
bandwidth against per-user H.265 video streaming. Runs on the card;
`--device cpu` runs the plain PyTorch versions instead.

    PYTHONPATH=src python -m repro_torch.examples.multi_client_session [--clients 8]
"""

import argparse
import dataclasses as dc

import numpy as np

from repro_torch.core.camera import StereoRig, TrajectoryConfig, walk_trajectory
from repro_torch.core.gaussians import CityConfig, generate_city
from repro_torch.core.lod_tree import build_lod_tree
from repro_torch.core.pipeline import SessionConfig
from repro_torch.core.video_model import (StreamConfig, nebula_bandwidth_bps,
                                          video_bandwidth_bps)
from repro_torch.device import resolve_device
from repro_torch.serve.lod_service import LodService

FOCAL = 260.0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--syncs", type=int, default=24)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    b = args.clients
    dev = resolve_device(args.device)

    leaves = generate_city(CityConfig(blocks_x=4, blocks_y=4, leaf_density=0.25),
                           device=dev)
    tree = build_lod_tree(leaves, target_subtrees=64, device=dev)
    print(f"scene: {tree.meta.n_real} nodes, {tree.meta.Ns} subtrees; {b} clients")

    # every client walks the same city on its own seed
    walks = []
    last_cams = []
    for c in range(b):
        cams = list(walk_trajectory(TrajectoryConfig(seed=c), args.syncs, (200.0, 200.0),
                                    focal_px=FOCAL, width=160, height=96, device=dev))
        walks.append(np.stack([cam.pos.cpu().numpy() for cam in cams]))
        last_cams.append(cams[-1])
    walks = np.stack(walks, axis=1)  # (syncs, B, 3)

    cfg = SessionConfig(tau=48.0, w=4, w_star=32, cut_budget=16384)
    # foveated fleet: half the clients run a looser (coarser) LoD threshold
    taus = np.where(np.arange(b) % 2 == 0, cfg.tau, 1.75 * cfg.tau).astype(np.float32)
    service = LodService(tree, cfg, b, focal=FOCAL, mode="pooled", taus=taus, device=dev)

    total_bytes = np.zeros(b)
    total_delta = total_unique = total_saved = 0.0
    for f in range(args.syncs):
        stats = service.sync(walks[f])
        sb = stats.sync_bytes.cpu().numpy()
        total_bytes += sb
        total_delta += float(stats.delta_size.sum())
        total_unique += float(stats.unique_delta.sum())
        total_saved += float(stats.dedup_bytes_saved.sum())
        if f < 4 or f % 8 == 0:
            print(f"sync {f:3d}: pool={int(stats.resweeps.sum()):4d}"
                  f"/{b * tree.meta.Ns} slabs  "
                  f"bytes/client med={np.median(sb)/1024:7.1f}KiB "
                  f"max={sb.max()/1024:7.1f}KiB  "
                  f"cut med={int(np.median(stats.cut_size.cpu().numpy()))}")

    print("\nper-client totals over the session:")
    for c in range(b):
        print(f"  client {c}: {total_bytes[c]/1024:8.1f} KiB "
              f"({total_bytes[c]/args.syncs/1024:6.2f} KiB/sync)")

    print(f"\nencode-once delta path: {int(total_unique)} unique of "
          f"{int(total_delta)} requested Δ Gaussians "
          f"({total_unique / max(total_delta, 1) * 100:.1f}%); "
          f"{total_saved / 1024:.1f} KiB fleet downlink saved vs per-client unicast")

    per_sync = total_bytes.mean() / args.syncs
    nb = nebula_bandwidth_bps(per_sync, cfg.w, 90.0)
    video = video_bandwidth_bps(StreamConfig())
    print(f"\nfleet mean bandwidth/client: nebula {nb/1e6:.1f} Mbps vs "
          f"H.265@VR {video/1e6:.0f} Mbps → {nb/video*100:.1f}% "
          f"(×{b} clients served from one tree)")

    # fallback tier: the cloud renders every client's queue in one fleet call
    rigs = [StereoRig(left=dc.replace(cam, width=96, height=64, cx=48.0, cy=32.0),
                      baseline=0.06) for cam in last_cams]
    il, ir, fstats = service.render_fallback(rigs, list_len=192)
    print(f"\nfallback render: {il.shape[0]} stereo frames "
          f"{il.shape[2]}x{il.shape[1]} in one batched dispatch; "
          f"per-client splats shared across eyes: "
          f"{fstats.shared_preprocess.tolist()}")


if __name__ == "__main__":
    main()
