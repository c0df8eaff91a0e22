"""K7's forward and each of its backward passes, timed on the card for one or
more source trees in turns.

    PYTHONPATH=src python tools/k7_passes.py [--tree DIR ...] [--dtype float32]
        [--rounds 2] [--out FILE]

Each tree (default: this checkout; a parent commit unpacked with `git
archive` into a directory that .gitignore lists) runs in a process of its
own, which builds that tree's kernels into the tree's own `build/` and
times, at phase 10's shapes (`chip_smoke.k7_backward_case_list`, which
ends with gemma3-4b's local layer, paligemma-3b's heads and gemma3-4b's
local and global layers at its training shape, and the float32 prefill of
`k7_case_list`), in each `--dtype` asked for (float32
by default; repeatable): the forward with lse, the whole backward, the
backward with only the dQ pass (`need_dkv=False`) and with only the dK/dV
pass (`need_dq=False`), by CUDA events over runs of back-to-back calls
(`chip_smoke.cuda_ms`), and the forward's and the whole backward's device
time (`chip_smoke.device_ms`, the profiler in a fresh process). Each row
also holds the sha256 of the forward's output and lse and of the
backward's dq, dk and dv on the case's seeded inputs, so that two trees'
bits can be compared. Trees go in turns, A B B A for two, `--rounds`
times, so that two versions are compared on one card (`_ab`). Prints a
line a (tree, case) and the card's name and power limit, and writes every
row to `--out` as JSON."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import _ab


def digest(*tensors) -> str:
    """sha256 of the tensors' bytes, in order."""
    import hashlib

    import torch
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def worker(tree: Path, dtype_names: list, reps: int) -> list:
    cs = _ab.enter_tree(tree)
    import torch
    from repro_torch.kernels import flash_attention as FA

    dev = torch.device("cuda")
    prefill = next(c for c in cs.k7_case_list() if c[6] == "float32")
    cases = [(prefill[0], *prefill[1:6], prefill[7], prefill[8])] + cs.k7_backward_case_list()
    rows = []
    for (name, b, h, hkv, length, d, causal, window), dtype_name in (
            (c, t) for t in dtype_names for c in cases):
        dtype = getattr(torch, dtype_name)
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

        dq, dk, dv = bwd()
        bits = {"forward_sha256": digest(out, lse), "backward_sha256": digest(dq, dk, dv)}
        del dq, dk, dv
        ms = {"forward": cs.cuda_ms(torch, fwd, reps),
              "forward_device": cs.device_ms(torch, fwd, "flash_attention"),
              "backward_device": cs.device_ms(torch, bwd, "attention_bwd",
                                              per_call=3 + (h > hkv))}
        for part, need in (("backward", {}), ("dq_pass", dict(need_dkv=False)),
                           ("dkv_pass", dict(need_dq=False))):
            ms[part] = cs.cuda_ms(torch, lambda: bwd(**need), reps)
        rows.append(dict(tree=str(tree), case=name, shape=[b, h, hkv, length, d],
                         dtype=dtype_name, causal=causal, window=window,
                         backward_route=FA.bwd_route(d, dtype).route, **ms, **bits))
        del q, k, v, dout, lse, out
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    _ab.add_args(ap)
    ap.add_argument("--dtype", action="append", default=None, choices=("float32", "bfloat16"),
                    help="a type to time (repeatable; default float32)")
    ap.add_argument("--reps", type=int, default=5, help="timed runs a case (median)")
    args = ap.parse_args()
    dtypes = args.dtype or ["float32"]
    if args.worker:
        print(json.dumps(worker(Path(args.worker), dtypes, args.reps)))
        return 0
    sys.path.insert(0, str(_ab.ROOT))
    import chip_smoke as cs

    rows, first = [], None
    for tree, runs in _ab.run_in_turns(__file__, args.tree, args.rounds,
                                       [*(a for t in dtypes for a in ("--dtype", t)),
                                        "--reps", str(args.reps)]):
        first = first or tree
        for r in runs:
            print(f"{Path(r['tree']).name:>12} {r['case']:<36} {r['dtype']} "
                  f"fwd {r['forward']:.4f} ms (device {cs.fmt_ms(r['forward_device'])}), bwd "
                  f"{r['backward']:.4f} ms (device {cs.fmt_ms(r['backward_device'])}; dQ pass "
                  f"{r['dq_pass']:.4f}, dK/dV pass {r['dkv_pass']:.4f}; route "
                  f"{r['backward_route']}; bits {r['forward_sha256'][:12]} "
                  f"{r['backward_sha256'][:12]})", flush=True)
            rows.append(r)
    ref, shown = {}, set()        # each case's bits in the first tree's first run
    for r in rows:
        if r["tree"] == str(first):
            ref.setdefault((r["case"], r["dtype"]), r)
    for r in rows:
        key = (r["tree"], r["case"], r["dtype"])
        if r["tree"] == str(first) or key in shown:
            continue
        shown.add(key)
        a = ref[(r["case"], r["dtype"])]
        same = [w for w in ("forward", "backward") if r[f"{w}_sha256"] == a[f"{w}_sha256"]]
        print(f"bits of {Path(r['tree']).name} against {first.name}, {r['case']} "
              f"{r['dtype']}: equal in {', '.join(same) or 'neither'}")
    _ab.finish(args.out, "rows", rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
