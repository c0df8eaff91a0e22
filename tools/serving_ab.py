"""Serving on the card, tree against tree: phases 9 and 14 of `chip_smoke.py`.

    python3 tools/serving_ab.py LABEL=DIR [LABEL=DIR ...] [--quick] [--out FILE]

Each DIR is a checkout of this repository (the tree itself, or the parent
commit unpacked with `git archive` into an ignored directory). The runs go
in the order given, one process each, so that "parent change change parent"
puts both on one card under one host's load. Each process builds that
tree's kernels and calls its own `chip_smoke.lm_serving` (qwen2.5-3b at 36
layers: prefill 4 x 2048, greedy decode) and `chip_smoke.lm_families` (the
six other families at full width), which time, profile and check as the
whole script does. A run prints one JSON line: each config's prefill ms,
median decode step ms, the decode steps' spread, the peak bytes, and the
idle share of one profiled decode step, beside the card's name and power
limit. With `--quick` a run only times the same configs' serving (a
warm-up, then a prefill of 4 x 2048 twice and 32 greedy decode steps, each
step to a synchronize; no checks, no profile) and counts the aten ops one
decode step dispatches: the host's work, which decode, idle 0.5-0.9 of a
step, waits on. `--out` also writes the lines there. Needs one card.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

_CHILD = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import torch
import chip_smoke as cs
from repro_torch.kernels import _build
_build.build()
_build.library()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
card = cs.card_line()
rows = []
lm = cs.lm_serving(torch, dev)
rows.append(dict(arch=lm["arch"], prefill_ms=lm["prefill_ms"],
                 decode_ms=lm["decode_step_ms_median"], decode_min=min(lm["decode_step_ms"]),
                 decode_max=max(lm["decode_step_ms"]), peak_bytes=lm["peak_bytes"],
                 decode_idle=lm.get("decode_idle_share")))
for r in cs.lm_families(torch, dev, card)["configs"]:
    rows.append(dict(arch=r["arch"], prefill_ms=r["prefill_ms"],
                     decode_ms=r["decode_step_ms_median"], decode_min=min(r["decode_step_ms"]),
                     decode_max=max(r["decode_step_ms"]), peak_bytes=r["peak_bytes"],
                     decode_idle=r.get("decode_idle_share")))
print("AB " + json.dumps({"card": card, "rows": rows}))
"""

_QUICK = r"""
import dataclasses, json, statistics, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import torch
from torch.utils._python_dispatch import TorchDispatchMode
import chip_smoke as cs
from repro_torch.configs import get_arch
from repro_torch.kernels import _build
from repro_torch.models import model_zoo
_build.build()
_build.library()
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


rows = []
b, s0, steps = cs.LM_BATCH, cs.LM_PROMPT, 32
for name, layers in ((cs.LM_ARCH, None),) + tuple(cs.FAMILY_ARCHS):
    cfg = get_arch(name)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    bundle = model_zoo.get_model(cfg)
    model = bundle.init(seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (b, s0), generator=gen, device=dev)
    batch = {"tokens": tokens, **cs.stub_inputs(torch, cfg, b, s0, gen, dev)}
    max_len = cfg.n_img_tokens + s0 + steps + 2
    warm = {"tokens": tokens[:, :128], **cs.stub_inputs(torch, cfg, b, 128, gen, dev)}
    bundle.decode_step(model, bundle.prefill(model, warm, max_len=cfg.n_img_tokens + 130)[1],
                       {"token": tokens[:, 0]})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pre = []
    for _ in range(2):
        t, (logits, cache) = ms(lambda: bundle.prefill(model, batch, max_len=max_len))
        pre.append(t)
    tok = logits[:, :cfg.vocab].argmax(-1)
    dec = []
    for _ in range(steps):
        t, (logits, cache) = ms(lambda: bundle.decode_step(model, cache, {"token": tok}))
        dec.append(t)
        tok = logits[:, :cfg.vocab].argmax(-1)
    with Count() as c:
        bundle.decode_step(model, cache, {"token": tok})
    rows.append(dict(arch=cfg.name, prefill_ms=min(pre), decode_ms=statistics.median(dec),
                     decode_min=min(dec), decode_max=max(dec),
                     peak_bytes=torch.cuda.max_memory_allocated(), decode_ops=c.n))
    del model, cache, logits
    torch.cuda.empty_cache()
print("AB " + json.dumps({"card": cs.card_line(), "rows": rows}))
"""


def main() -> int:
    args = sys.argv[1:]
    out = None
    child = _CHILD
    if "--quick" in args:
        args.remove("--quick")
        child = _QUICK
    if "--out" in args:
        i = args.index("--out")
        out = Path(args[i + 1])
        del args[i:i + 2]
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    lines = []
    for item in args:
        label, tree = item.split("=", 1)
        tree = str(Path(tree).resolve())
        env = dict(os.environ, PYTHONPATH=str(Path(tree) / "src"))
        p = subprocess.run([sys.executable, "-c", child, tree], cwd=tree, env=env,
                           capture_output=True, text=True)
        got = [ln for ln in p.stdout.splitlines() if ln.startswith("AB ")]
        if p.returncode != 0 or not got:
            print(f"{label}: exit {p.returncode}\n{p.stdout[-2000:]}\n{p.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        rec = {"label": label, **json.loads(got[-1][3:])}
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
