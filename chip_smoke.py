#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    PYTHONPATH=src python3 chip_smoke.py [--frames 16] [--blocks 24] [--out FILE]

Phases, each of which raises on failure (the script then exits non-zero):
  1. build every CUDA kernel of the port from `src/repro_torch/kernels/csrc`;
  2. build the city scene and its LoD tree, size the session's budgets;
  3. hold each kernel against its plain PyTorch version on the card, at the
     shapes of the session's first frames, and time both;
  4. check, on a small input, that the tiled stereo render agrees with the
     untiled per-pixel reference;
  5. run the single-client collaborative session (LoD sync every 4 frames,
     stereo render every frame) with every launch counter set to 0 first,
     and require that every kernel launched; then check each sync's cut
     against a full search and time the stages of one more frame;
  6. trace one more sync and rendered frame with torch.profiler (device
     busy time and the kernels that take it).
The last three lines are the kernel report (JSON), the card's name and power
limit, and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

REPS = 10                    # timed kernel launches (median)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
FP32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Median milliseconds of `fn` on the card (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--blocks", type=int, default=24)
    ap.add_argument("--out", type=str, default=None, help="also write the report here")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch import kernels as K
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    from repro_torch.core import camera as C
    from repro_torch.core import gaussians as G
    from repro_torch.core import lod_search as LS
    from repro_torch.core import pipeline as P
    from repro_torch.core.binning import pair_spans
    from repro_torch.core.lod_tree import build_lod_tree
    from repro_torch.core.projection import depth_ranks
    from repro_torch.core.stereo import build_merge_sources
    from repro_torch.kernels import _build
    from repro_torch.kernels import lod_cut, preprocess, rasterize, stereo_shift
    from repro_torch import render as R
    from repro_torch.render import stages as RS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card} | {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    report = {"card": card, "phases": {}}

    # 1. build ---------------------------------------------------------------
    b = _build.build()
    _build.library()
    ptxas = [ln.strip() for ln in b["ptxas"].splitlines()
             if "Used" in ln or "Compiling entry" in ln]
    log(f"[build] {b['seconds']:.1f} s, rebuilt={b['rebuilt']} -> {b['path']}")
    for ln in ptxas:
        log(f"[build] {ln}")
    report["phases"]["build_s"] = b["seconds"]

    # 2. scene, rigs, budgets --------------------------------------------------
    t0 = time.perf_counter()
    city = G.CityConfig(blocks_x=args.blocks, blocks_y=args.blocks, leaf_density=1.0, seed=2)
    leaves = G.generate_city(city, device=dev)
    tree = build_lod_tree(leaves, target_subtrees=1024, seed=0, device=dev)
    m = tree.meta
    build_s = time.perf_counter() - t0
    log(f"[scene] {args.blocks}x{args.blocks} blocks: {m.n_leaves} leaves, {m.n_real} real "
        f"nodes, {tree.n_pad} padded; T={m.T} Ns={m.Ns} S={m.S} slab depth "
        f"{m.slab_max_depth}; host build {build_s:.1f} s")
    report["scene"] = dict(blocks=args.blocks, leaves=m.n_leaves, n_real=m.n_real,
                           n_pad=tree.n_pad, T=m.T, Ns=m.Ns, S=m.S,
                           slab_max_depth=m.slab_max_depth, build_s=build_s)
    width, height = C.VR_EYE_RES
    rigs = [C.StereoRig(left=dataclasses.replace(cam, near=0.25), baseline=0.06)
            for cam in C.walk_trajectory(C.TrajectoryConfig(), args.frames, city.extent,
                                         focal_px=1400.0, width=width, height=height,
                                         device=dev)]
    base = P.SessionConfig(tau=48.0, w=4, w_star=32, use_compression=False)
    focal = 1400.0
    sync_frames = list(range(0, args.frames, base.w))
    cuts = {}
    for f in sync_frames:
        cut, _ = LS.full_search(tree, rigs[f].left.pos, focal, base.tau)
        cuts[f] = cut.mask(tree)
    max_cut = max(int(c.sum()) for c in cuts.values())
    cut_budget = pow2_at_least(max_cut)
    rcfg0 = R.RenderConfig.for_rig(rigs[0], tile=base.tile, list_len=base.list_len)

    def queue_of(mask, budget):
        return P._render_queue(tree.gaussians, LS.compact_ids(mask, budget))

    max_total = 0
    for i, rig in enumerate(rigs):
        s, _ = R.project(queue_of(cuts[(i // base.w) * base.w], cut_budget), rig, rcfg0)
        _x0, _y0, span_w, span_h = pair_spans(s.mean2d, s.ext, s.visible,
                                              rcfg0.wide_width, rcfg0.height, base.tile)
        max_total = max(max_total, int((span_w * span_h).sum()))
    max_pairs = pow2_at_least(max_total)
    cfg = dataclasses.replace(base, cut_budget=cut_budget, max_pairs=max_pairs)
    rcfg = R.RenderConfig.for_rig(rigs[0], tile=cfg.tile, list_len=cfg.list_len,
                                  max_pairs=cfg.max_pairs)
    log(f"[budgets] largest cut {max_cut} -> cut_budget {cut_budget}; largest pair "
        f"count {max_total} -> max_pairs {max_pairs}; n_cat {rcfg.n_cat}, wide grid "
        f"{rcfg.tiles_x_wide}x{rcfg.tiles_y} tiles, right {rcfg.tiles_x}x{rcfg.tiles_y}")
    if cut_budget < max_cut or max_pairs < max_total:
        raise AssertionError("budget sizing failed")
    report["budgets"] = dict(max_cut=max_cut, cut_budget=cut_budget,
                             max_pairs_needed=max_total, max_pairs=max_pairs,
                             n_cat=rcfg.n_cat)

    # 3. kernels against their plain versions, at the session's shapes --------
    kernels = {}
    cam0 = rigs[0].left.pos
    top_expand, _ = LS.top_sweep(tree, cam0, focal, cfg.tau)
    rpe = LS._root_parent_expand(tree, top_expand)
    sweep_args = (tree.slab_mu(), tree.slab_size(), tree.slab_parent, tree.slab_level,
                  tree.slab_is_leaf, tree.slab_valid, rpe, cam0, focal, cfg.tau)
    md = m.slab_max_depth
    k_out = lod_cut.lod_slab_sweep(*sweep_args, max_depth=md)
    p_out = lod_cut.slab_sweep_plain(*sweep_args, max_depth=md)
    torch.cuda.synchronize()
    if not (torch.equal(k_out[0], p_out[0]) and torch.equal(k_out[1], p_out[1])):
        raise AssertionError("K1: in_cut/root_expand differ from the plain version "
                             f"({int((k_out[0] != p_out[0]).sum())} nodes)")
    fin = torch.isfinite(p_out[2])
    if not torch.equal(fin, torch.isfinite(k_out[2])) or not torch.allclose(
            k_out[2][fin], p_out[2][fin], rtol=1e-6, atol=0.0):
        raise AssertionError("K1: rho differs from the plain version beyond 1e-6")
    n_nodes = m.Ns * m.S
    k1_bytes = n_nodes * (12 + 4 + 4 + 4 + 1 + 1) + m.Ns + 12 + n_nodes + m.Ns * 5
    kernels["lod_slab_sweep"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/lod_cut.cu",
        replaces="src/repro/kernels/lod_cut.py:127",
        max_abs_err=float((k_out[2][fin] - p_out[2][fin]).abs().max()) if fin.any() else 0.0,
        ms=cuda_ms(torch, lambda: lod_cut.lod_slab_sweep(*sweep_args, max_depth=md),
                   REPS),
        plain_ms=cuda_ms(torch, lambda: lod_cut.slab_sweep_plain(*sweep_args, max_depth=md),
                         3),
        bytes=k1_bytes, ops=n_nodes * 22)

    q0 = queue_of(cuts[0], cut_budget)
    wide = rcfg.widened(rigs[0].left)
    sk = preprocess.preprocess(q0, rigs[0], wide)
    sp = preprocess.preprocess_plain(q0, rigs[0], wide)
    torch.cuda.synchronize()
    err3 = 0.0
    for name in ("mean2d", "depth", "conic", "ext", "color_l", "color_r", "opacity",
                 "disparity"):
        # splats behind the camera overflow to inf/nan on both sides
        a, b_ = getattr(sk, name), getattr(sp, name)
        if not torch.allclose(a, b_, rtol=2e-5, atol=2e-5, equal_nan=True):
            bad = ~torch.isclose(a, b_, rtol=2e-5, atol=2e-5, equal_nan=True)
            rows = bad.reshape(bad.shape[0], -1).any(1)
            log(f"[K3] {name}: {int(rows.sum())} rows differ, {int((rows & sp.visible).sum())} "
                f"visible; depth of those {sp.depth[rows][:8].tolist()}; kernel "
                f"{a[rows][:4].tolist()} plain {b_[rows][:4].tolist()}")
            raise AssertionError(f"K3: {name} differs from the plain version beyond 2e-5")
        both = torch.isfinite(a) & torch.isfinite(b_)
        if both.any():
            err3 = max(err3, float((a[both] - b_[both]).abs().max()))
    if not torch.equal(sk.visible, sp.visible):
        raise AssertionError(f"K3: visible differs on {int((sk.visible != sp.visible).sum())}")
    n_q, kk = q0.n, q0.sh.shape[1]
    kernels["preprocess"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/preprocess.cu",
        replaces="src/repro/kernels/preprocess.py:140", max_abs_err=err3,
        ms=cuda_ms(torch, lambda: preprocess.preprocess(q0, rigs[0], wide), REPS),
        plain_ms=cuda_ms(torch, lambda: preprocess.preprocess_plain(q0, rigs[0], wide), 3),
        bytes=n_q * (3 + 3 + 4 + 1 + 3 * kk) * 4 + 26 * 4 + n_q * 17 * 4,
        ops=n_q * (278 + 18 * kk))

    ranks = depth_ranks(sk)
    left = R.bin_shared(sk, ranks, rcfg)
    src_r, src_i = build_merge_sources(left, sk, ranks, tile=rcfg.tile, width=rcfg.width,
                                       n_cat=rcfg.n_cat)
    mk = stereo_shift.stereo_merge_kernel(src_r, src_i)
    mp = stereo_shift.stereo_merge_plain(src_r, src_i)
    torch.cuda.synchronize()
    for name, a, b_ in zip(("ids", "count", "overflow"), mk, mp):
        if not torch.equal(a, b_):
            raise AssertionError(f"K4: {name} differs from the plain version")
    live = int((src_r < stereo_shift.INF_RANK).sum())
    n_rt = src_r.shape[0]
    kernels["stereo_merge"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/stereo_shift.cu",
        replaces="src/repro/kernels/stereo_shift.py:57", max_abs_err=0.0,
        ms=cuda_ms(torch, lambda: stereo_shift.stereo_merge_kernel(src_r, src_i), REPS),
        plain_ms=cuda_ms(torch, lambda: stereo_shift.stereo_merge_plain(src_r, src_i), 3),
        bytes=live * 8 + n_rt * (rcfg.n_cat * 4 + rcfg.list_len * 4 + 4 + 1),
        ops=live * rcfg.n_cat)

    ent, counts = rasterize.gather_entries(left, sk, "left")
    origins = rasterize.tile_origins(ent.shape[0], left.tiles_x, rcfg.tile, dev)
    counts = counts.contiguous()
    rk = rasterize.rasterize_slabs(ent, counts, origins, tile=rcfg.tile)
    rp = rasterize.rasterize_slabs_plain(ent, counts, origins, tile=rcfg.tile,
                                         with_processed=True)
    torch.cuda.synchronize()
    if not torch.allclose(rk[0], rp[0], rtol=1e-5, atol=1e-6):
        raise AssertionError("K2: tile image differs from the plain version beyond "
                             "rtol 1e-5 / atol 1e-6")
    if not torch.equal(rk[1], rp[1]):
        raise AssertionError(f"K2: hits differ on {int((rk[1] != rp[1]).sum())} entries")
    # the kernel blends a tile's entries until no pixel lets light through:
    # its work is the entries blended, not the entries gathered
    n_t, n_gathered = ent.shape[0], int(counts.clamp_max(ent.shape[1]).sum())
    n_ent = int(rp[2].sum())
    px = rcfg.tile * rcfg.tile
    kernels["rasterize_slabs"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/rasterize.cu",
        replaces="src/repro/kernels/rasterize.py:77",
        max_abs_err=float((rk[0] - rp[0]).abs().max()),
        ms=cuda_ms(torch, lambda: rasterize.rasterize_slabs(ent, counts, origins,
                                                            tile=rcfg.tile), REPS),
        plain_ms=cuda_ms(torch, lambda: rasterize.rasterize_slabs_plain(
            ent, counts, origins, tile=rcfg.tile), 3),
        bytes=n_ent * 36 + n_t * (4 + 8 + px * 12 + ent.shape[1]), ops=n_ent * px * 25)
    for name, k in kernels.items():
        k["bound_ms"], k["bound_by"] = bound(k["bytes"], k["ops"])
        log(f"[kernel] {name}: {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, bound "
            f"{k['bound_ms']:.4f} ms ({k['bound_by']}), max |err| {k['max_abs_err']:.3g}")
    shapes = dict(slabs=[m.Ns, m.S], queue=n_q, left_tiles=n_t, right_tiles=n_rt,
                  live_merge_entries=live, raster_entries_gathered=n_gathered,
                  raster_entries_blended=n_ent)
    log(f"[kernel] shapes {json.dumps(shapes)}")
    report["kernel_shapes"] = shapes
    del src_r, src_i, ent, rk, rp, mk, mp

    # 4. small-input reference: tiled stereo (kernels) vs untiled per pixel ----
    g_small = G.random_gaussians(np.random.default_rng(0), 600,
                                 sh_degree=1, extent=6.0, device=dev)
    rig_small = C.StereoRig(left=C.make_camera([0, -18, 2], [0, 0, 0], focal_px=220.0,
                                               width=128, height=96, near=0.2, device=dev),
                            baseline=0.06)
    il, ir, (_s, ll, rl, _st) = P.render_stereo(g_small, rig_small, tile=16, list_len=256)
    ref_l, ref_r = P.render_stereo_reference(g_small, rig_small)
    torch.cuda.synchronize()
    if bool(ll.overflow) or bool(rl.overflow):
        raise AssertionError("small reference scene overflowed its budgets")
    for a, b_, eye in ((il, ref_l, "left"), (ir, ref_r, "right")):
        if not torch.allclose(a, b_, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"tiled {eye} eye differs from the untiled reference")
    bitwise = bool(torch.equal(il, ref_l) and torch.equal(ir, ref_r))
    log(f"[reference] 600 splats at 128x96: tiled stereo == untiled reference "
        f"(allclose; bitwise={bitwise})")
    report["reference_bitwise"] = bitwise

    # 5. the session -----------------------------------------------------------
    sess = P.CollaborativeSession(tree, cfg, rigs[0])
    torch.cuda.synchronize()
    K.reset_launch_counts()
    frames = []
    sync_cuts = {}
    t_run = time.perf_counter()
    for i, rig in enumerate(rigs):
        t1 = time.perf_counter()
        st, out = sess.step(rig, render=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        il, ir, (_s, ll, rl, sst) = out
        if tuple(il.shape) != (height, width, 3) or tuple(ir.shape) != (height, width, 3):
            raise AssertionError(f"frame {i}: image shape {tuple(il.shape)}")
        if not (torch.isfinite(il).all() and torch.isfinite(ir).all()):
            raise AssertionError(f"frame {i}: non-finite pixels")
        if float(il.max()) <= 0 or float(ir.max()) <= 0:
            raise AssertionError(f"frame {i}: blank image")
        if st.synced:
            sync_cuts[i] = (sess.state.cut_gids.clone(), st.cut_size)
        row = dict(dataclasses.asdict(st), ms=ms, left_overflow=bool(ll.overflow),
                   right_overflow=bool(rl.overflow), stereo=dataclasses.asdict(sst))
        frames.append(row)
        log(f"[frame {i:2d}] synced={st.synced} cut={st.cut_size} delta={st.delta_size} "
            f"bytes={st.sync_bytes:.0f} touched={st.nodes_touched} resweeps={st.resweeps} "
            f"resident={st.client_resident} overflow(L,R)=({row['left_overflow']},"
            f"{row['right_overflow']}) right_candidates={sst.right_candidates} "
            f"alpha_skipped={sst.right_alpha_skipped} {ms:.1f} ms")
    run_s = time.perf_counter() - t_run
    counts_run = K.launch_counts()
    log(f"kernels {json.dumps(counts_run)}")
    missing = [k for k, v in counts_run.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    log(f"[session] {args.frames} frames in {run_s:.2f} s")
    report["frames"] = frames

    # every sync's cut equals a full search at the same camera
    for i, (gids, count) in sync_cuts.items():
        full, _ = LS.full_search(tree, rigs[i].left.pos, focal, cfg.tau)
        want, n_want, _ = LS.cut_gids(full, tree, cfg.cut_budget)
        if not torch.equal(gids, want) or int(n_want) != count:
            raise AssertionError(f"frame {i}: temporal cut differs from a full search")
    log(f"[session] the {len(sync_cuts)} temporal cuts equal full searches")

    # per-stage times of one more sync frame and its render: the session's
    # own calls, each stage function wrapped with a synchronize on both sides
    stages = {}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            stages[name] = stages.get(name, 0.0) + (time.perf_counter() - t2) * 1e3
            return r
        return run

    rig = rigs[-1]
    state = dataclasses.replace(sess.state, frame_index=0)
    with contextlib.ExitStack() as patches:
        for mod, name in ((P, "session_step"), (P, "_render_queue"), (RS, "project"),
                          (RS, "bin_shared"), (RS, "stereo_merge"),
                          (RS, "rasterize"), (P, "alpha_skip_stats")):
            patches.enter_context(mock.patch.object(mod, name, timed(name, getattr(mod, name))))
        state, _ = P.session_step(sess.tree, sess.codec, cfg, state, rig.left.pos, focal,
                                  sess.bytes_per_g)
        timed("client_render_step", P.client_render_step)(cfg, state, rig)
    log(f"[stages] {json.dumps({k: round(v, 3) for k, v in stages.items()})}")
    report["stages_ms"] = stages

    # 6. device time of one sync + one rendered frame (torch.profiler) ------
    from torch.profiler import ProfilerActivity, profile
    state = dataclasses.replace(state, frame_index=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t3 = time.perf_counter()
        state, _ = P.session_step(sess.tree, sess.codec, cfg, state, rig.left.pos, focal,
                                  sess.bytes_per_g)
        P.client_render_step(cfg, state, rig)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t3) * 1e3
    by_name = {}  # device-side events only (kernels, copies, sets)
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + ev.self_device_time_total / 1e3
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    if busy_ms > 0:
        log(f"[profile] sync + render frame: wall {wall_ms:.2f} ms (profiler on), device "
            f"busy {busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
        for name, t in top:
            log(f"[profile]   {t:9.3f} ms  {name[:90]}")
    else:
        log("[profile] the profiler recorded no device time: not measured")
    report["profile"] = dict(wall_ms=wall_ms, device_busy_ms=busy_ms, top=top)

    rows = []
    for name, k in kernels.items():
        rows.append(dict(name=name, route=k["route"], source=k["source"],
                         replaces=k["replaces"], launches=counts_run[name],
                         max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
                         bound_ms=k["bound_ms"], bound_by=k["bound_by"], library_ms=None))
    report["kernels"] = rows
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
