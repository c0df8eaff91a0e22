"""The control of the output check: the reference itself, computed in
bfloat16 (the step below the configuration's float32), put in the
program's place and compared as a run's outputs are. A sound check reads it
as not correct. The benchmark's own runs never run this.

    python3 nebula_bench/control.py --workload city24-quest3.walk --seeds 1 2 3 \
        --steps 180 [--out FILE]

`--steps` is the frames (session) or syncs (fleet) a run makes; the
comparison samples as a run does: two steps early on and the last."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from nebula_bench import harness as H
    from nebula_bench import scene as SC
    from nebula_bench import traffic as TR
    from nebula_bench.reference import fleet as RFL
    from nebula_bench.reference import session as RSE
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    w, c, _bench = H.find_cell(ROOT, args.workload)
    cfg = H.load_json(ROOT / c["file"])
    traffic = H.load_json(ROOT / "nebula_bench" / "traffic" / f"{w['traffic']}.json")
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        scene = SC.build_scene(cfg, seed)
        last = args.steps - 1
        samples = {cfg.get("warmup_frames", cfg.get("warmup_syncs", 0)) + 3,
                   cfg.get("warmup_frames", cfg.get("warmup_syncs", 0)) + 6, last}
        out = dict(seed=seed)
        for name, dtype in (("control", torch.bfloat16),):
            diag = {}
            if cfg["kind"] == "session":
                pos, rot = (torch.as_tensor(x, device=dev) for x in
                            TR.Headset(traffic, cfg["city"], seed, 0).poses(0, args.steps))
                got = RSE.Replay(RSE.Model(scene, cfg, dev, dtype), pos, rot, last, samples)
                checks, _w, _p = RSE.compare(got, RSE.Model(scene, cfg, dev), pos, rot, last,
                                             samples, diag)
            else:
                n, step = cfg["fleet"]["clients"], cfg["session"]["w"]
                cams = torch.stack([torch.as_tensor(
                    TR.Headset(traffic, cfg["city"], seed, b).poses(0, args.steps * step)[0]
                    [::step], device=dev) for b in range(n)], 1)
                got = RFL.Replay(RFL.Model(scene, cfg, dev, dtype), cams, samples)
                checks, _w = RFL.compare(got, RFL.Model(scene, cfg, dev), cams, samples, diag)
            judged = H.judge(checks, cfg["limits"])
            out[name] = dict(correct=H.passed(judged), checks=checks, gaps=diag)
        out["seconds"] = time.perf_counter() - t0
        rows.append(out)
        print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
