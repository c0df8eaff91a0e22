"""K7's forward and each of its backward passes, timed on the card for one or
more source trees in turns.

    PYTHONPATH=src python tools/k7_passes.py [--tree DIR ...] [--dtype float32]
        [--rounds 2] [--out FILE]

Each tree (default: this checkout; a parent commit unpacked with `git
archive` into a directory that .gitignore lists) runs in a process of its
own, which builds that tree's kernels into the tree's own `build/` and
times, at phase 10's shapes (`chip_smoke.k7_backward_case_list` and the
float32 prefill of `k7_case_list`) and at paligemma-3b's head dim 256 (1 x
8/1 heads over 2048, causal): the forward with lse, the whole
backward, the backward with only the dQ pass (`need_dkv=False`) and with
only the dK/dV pass (`need_dq=False`), by CUDA events over runs of
back-to-back calls (`chip_smoke.cuda_ms`), and the forward's and the
whole backward's device time (`chip_smoke.device_ms`, the profiler in a
fresh process). Trees go in turns, A B B A for
two, `--rounds` times, so that two versions are compared on one card.
Prints a line a (tree, case) and the card's name and power limit, and
writes every row to `--out` as JSON."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worker(tree: Path, dtype_name: str, reps: int) -> list:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                       # shapes and timing only
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    assert Path(FA.__file__).resolve().is_relative_to(tree.resolve()), FA.__file__

    _build.build()
    dev = torch.device("cuda")
    dtype = getattr(torch, dtype_name)
    prefill = next(c for c in cs.k7_case_list() if c[6] == "float32")
    pg = get_arch("paligemma-3b")             # the float32 kernels' bucket 256
    cases = ([(prefill[0], *prefill[1:6], prefill[7], prefill[8])] + cs.k7_backward_case_list()
             + [(f"{pg.name} head dim {pg.hd}", 1, pg.n_heads, pg.n_kv_heads, cs.LM_PROMPT,
                 pg.hd, True, 0)])
    rows = []
    for name, b, h, hkv, length, d, causal, window in cases:
        gen = torch.Generator(device=dev).manual_seed(7 * length + d)
        q, k, v, dout = (torch.randn((b, length, n, d), generator=gen, device=dev)
                         .to(dtype).transpose(1, 2) for n in (h, hkv, hkv, h))
        lse = torch.empty((b, h, length), dtype=torch.float32, device=dev)
        out = FA._launch(q, k, v, causal, window, lse)
        kw = dict(causal=causal, window=window)
        def fwd():
            return FA._launch(q, k, v, causal, window, lse)

        def bwd(**need):
            return FA.flash_attention_backward(q, k, v, out, lse, dout, **kw, **need)

        ms = {"forward": cs.cuda_ms(torch, fwd, reps),
              "forward_device": cs.device_ms(torch, fwd, "flash_attention"),
              "backward_device": cs.device_ms(torch, bwd, "attention_bwd",
                                              per_call=3 + (h > hkv))}
        for part, need in (("backward", {}), ("dq_pass", dict(need_dkv=False)),
                           ("dkv_pass", dict(need_dq=False))):
            ms[part] = cs.cuda_ms(torch, lambda: bwd(**need), reps)
        rows.append(dict(tree=str(tree), case=name, shape=[b, h, hkv, length, d],
                         dtype=dtype_name, causal=causal, window=window, **ms))
        del q, k, v, dout, lse, out
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=None,
                    help="a source tree to time (repeatable; default this checkout)")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--rounds", type=int, default=1, help="A B B A rounds")
    ap.add_argument("--reps", type=int, default=5, help="timed runs a case (median)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(Path(args.worker), args.dtype, args.reps)))
        return 0
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    trees = [Path(t).resolve() for t in (args.tree or [str(ROOT)])]
    order = []
    for _ in range(args.rounds):
        order += trees + trees[::-1] if len(trees) > 1 else trees
    rows = []
    for tree in order:
        out = subprocess.run([sys.executable, __file__, "--worker", str(tree), "--dtype",
                              args.dtype, "--reps", str(args.reps)],
                             capture_output=True, text=True, check=False)
        if out.returncode != 0:
            raise RuntimeError(f"{tree}: {out.stderr[-4000:]}")
        for r in json.loads(out.stdout.strip().splitlines()[-1]):
            print(f"{Path(r['tree']).name:>12} {r['case']:<36} {r['dtype']} "
                  f"fwd {r['forward']:.4f} ms (device {cs.fmt_ms(r['forward_device'])}), bwd "
                  f"{r['backward']:.4f} ms (device {cs.fmt_ms(r['backward_device'])}; dQ pass "
                  f"{r['dq_pass']:.4f}, dK/dV pass {r['dkv_pass']:.4f})", flush=True)
            rows.append(r)
    card = cs.card_line()
    print(card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
