"""Find a configuration's budgets as a deployment would: the largest need
over a traffic mix's seeds and frames, by the reference's own search and
projection (the program is not run).

    python3 nebula_bench/size_budgets.py --config city24-quest3 --traffic walk \
        --seeds 1 2 3 --frames 1024 [--out FILE]

Session configurations: the largest cut, and the largest (splat, tile) pair
count of the widened left eye before the precise cull (what the program's
pair budget has to hold), over every frame. Fleet configurations: the
largest cut of any client, and the largest Δ-union of a sync (the cold one
included). Prints one JSON line a seed and the maxima with the powers of
two at or above them."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def wide_pairs(rows, pos, rot, rig: dict, tile: int) -> int:
    """(splat, tile) pairs of the widened left eye before the precise cull."""
    import torch
    from nebula_bench.reference import render as RR
    w, h = rig["width"], rig["height"]
    n_cat = int(rig["baseline"] * rig["focal"] / rig["near"] // tile) + 2
    wide = (-(-w // tile) + n_cat - 1) * tile
    mean, _d, _c, ext, _col, _o, vis = RR.project(rows, pos, rot, rig["focal"], w / 2.0,
                                                  h / 2.0, rig["near"], rig["far"], wide, h,
                                                  torch.float32)
    _x0, _y0, span_w, span_h = RR.spans(mean, ext, vis, wide, h, tile)
    return int((span_w * span_h).sum())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from nebula_bench import harness as H
    from nebula_bench import scene as SC
    from nebula_bench import traffic as TR
    from nebula_bench.reference import lod as RL
    from nebula_bench.reference import session as RS
    from nebula_bench.reference import tables as RT
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    bench = H.load_json(ROOT / "BENCHMARK.json")
    cfg = H.load_json(ROOT / {c["name"]: c for c in bench["configs"]}[args.config]["file"])
    traffic = H.load_json(ROOT / "nebula_bench" / "traffic" / f"{args.traffic}.json")
    s, rig = cfg["session"], cfg["rig"]
    focal = float(torch.tensor(rig["focal"], dtype=torch.float32))
    rows_out = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        scene = SC.build_scene(cfg, seed)
        tree = RL.Tree(scene, dev)
        if cfg["kind"] == "session":
            model = RS.Model(scene, cfg, dev)
            pos, rot = (torch.as_tensor(x, device=dev) for x in
                        TR.Headset(traffic, cfg["city"], seed, 0).poses(0, args.frames))
            most_cut = most_pairs = 0
            for f in range(args.frames):
                model.frame(f, pos[f])
                if f % s["w"] == 0:
                    most_cut = max(most_cut, int(model.cut.sum()))
                    queue = model.rows(torch.nonzero(model.cut, as_tuple=True)[0])
                most_pairs = max(most_pairs, wide_pairs(queue, pos[f], rot[f], rig, s["tile"]))
            row = dict(seed=seed, cut=most_cut, pairs=most_pairs)
        else:
            n, w = cfg["fleet"]["clients"], s["w"]
            taus = cfg["fleet"]["taus"]
            heads = [TR.Headset(traffic, cfg["city"], seed, c) for c in range(n)]
            cams = [torch.as_tensor(h.poses(0, args.frames)[0][::w], device=dev) for h in heads]
            clients = [RT.Client(scene.n_pad, dev) for _ in range(n)]
            most_cut = most_union = 0
            for k in range(args.frames // w):
                union = torch.zeros(scene.n_pad, dtype=torch.bool, device=dev)
                for b in range(n):
                    cut = tree.cut(cams[b][k], focal, float(taus[b % len(taus)]))
                    delta, _ = clients[b].sync(cut, k, s["w_star"])
                    union |= delta
                    most_cut = max(most_cut, int(cut.sum()))
                most_union = max(most_union, int(union.sum()))
            row = dict(seed=seed, cut=most_cut, union=most_union)
        row["seconds"] = time.perf_counter() - t0
        rows_out.append(row)
        print(json.dumps(row), flush=True)
    out = dict(config=args.config, traffic=args.traffic, frames=args.frames,
               seeds=args.seeds, rows=rows_out)
    for key in ("cut", "pairs", "union"):
        if key in rows_out[0]:
            most = max(r[key] for r in rows_out)
            out[f"most_{key}"], out[f"pow2_{key}"] = most, pow2_at_least(most)
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
