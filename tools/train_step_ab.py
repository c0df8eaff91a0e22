"""One LM config's full-width train step (`chip_smoke.train_full`, phase 15
(a) and (d)) on the card, for one or more source trees in turns.

    PYTHONPATH=src python tools/train_step_ab.py [--tree DIR ...]
        [--arch gemma3-4b] [--steps 3] [--rounds 1] [--out FILE]

Each tree (default: this checkout; a parent commit unpacked with `git
archive` into a directory that .gitignore lists) runs in a process of its
own, which builds that tree's kernels into the tree's own `build/` and
runs the config as published (bf16, remat) through that tree's
`make_train_step` at phase 15's 1 x 4096 tokens: a warm-up step with every
gradient checked, `--steps` timed steps (losses falling, K7's launch
counts held) and a profiled step. Trees go in turns, A B B A for two,
`--rounds` times (`_ab`). Prints a line a run (step ms median, MFU, peak, idle
share, the attention backward's device ms and share, K7's backward route)
and the card's name and power limit, and writes every record to `--out`
as JSON."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import _ab


def worker(tree: Path, arch: str, steps: int) -> dict:
    cs = _ab.enter_tree(tree)
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as FA

    cfg = get_arch(arch)
    counts = {name: 0 for name in K.launch_counts()}
    rec = cs.train_full(torch, torch.device("cuda"), cs.card_line(), cfg, steps, "ab", counts)
    rec.update(tree=str(tree), k7_backward_route=FA.bwd_route(cfg.hd, torch.bfloat16).route)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    _ab.add_args(ap)
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--steps", type=int, default=3, help="timed steps after the warm-up")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(Path(args.worker), args.arch, args.steps), default=str))
        return 0
    sys.path.insert(0, str(_ab.ROOT))
    import chip_smoke as cs

    recs = []
    for tree, r in _ab.run_in_turns(__file__, args.tree, args.rounds,
                                    ["--arch", args.arch, "--steps", str(args.steps)]):
        prof = r["profile"]
        print(f"{tree.name:>12} {r['arch']} {r['layers']} layers: step median "
              f"{r['step_ms_median']:.2f} ms (steps {[round(x, 2) for x in r['step_ms']]}), "
              f"MFU {r['mfu']:.4f}, peak {r['peak_bytes'] / 2**30:.2f} GiB, idle "
              f"{cs.fmt_share(r['idle_share'])}, attention backward "
              f"{prof['attention_backward_ms']:.2f} device ms "
              f"({cs.fmt_share(r['attention_backward_share'])} of "
              f"{prof['device_busy_ms']:.2f}), route {r['k7_backward_route']}; losses "
              f"{[round(x, 4) for x in r['losses']]}", flush=True)
        recs.append(r)
    _ab.finish(args.out, "runs", recs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
