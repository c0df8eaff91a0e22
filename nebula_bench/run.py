"""Run one cell of the benchmark once and print its result line.

    python3 nebula_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for. With `--trace 0` the result carries the cell's end-to-end
metrics, with `--trace 1` its per-layer metrics and the device trace. The
last line of standard output is one JSON object; the numbers compared to
decide `correct` are also the last lines of standard error."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def process_start() -> float:
    """perf_counter() at the process's start (Linux: from /proc)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        age = up - ticks / os.sysconf("SC_CLK_TCK")
        return T_START - max(0.0, min(age, 60.0))
    except (OSError, ValueError, IndexError):
        return T_START


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from nebula_bench import harness as H
    H.cache_dirs(ROOT)

    import torch
    try:
        _, _, bench = H.find_cell(ROOT, args.workload)
        workload = {w["name"]: w for w in bench["workloads"]}[args.workload]
    except (OSError, KeyError) as e:
        print(f"nebula_bench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        print(f"nebula_bench: the cell needs {workload['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"nebula_bench: the program is not here: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line, _ = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), t_start)
    if line is None:
        return 4
    print(line, flush=True)
    return 0


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, dev,
             t_start: float):
    """(result line, the numbers compared) of one run; (None, ...) where a
    module that must not load was loaded."""
    import torch
    from nebula_bench import harness as H
    cell, workload, bench = H.make_cell(root, workload, seed, seconds, trace, dev, t_start)
    out = H.kind_module(cell.config["kind"]).run(cell)
    found = H.forbidden_modules()
    if found:
        print(f"nebula_bench: modules that must not load were loaded: {found}",
              file=sys.stderr)
        return None, None
    if trace:
        tr = out["trace"]
        metrics = {}
        for m in cell.per_layer:
            v = m["reader"](tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        extra = dict(busy_s=tr["busy_s"], window_s=tr["window_s"])
        breakdown = dict(device_ops=[[n, s] for n, s in tr["device_ops"]],
                         idle_gaps=[[n, s] for n, s in tr["idle_gaps"]])
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": units[m["name"]]}
                   for m in bench["end_to_end"] if H.applies(m, workload, bench)}
        extra, breakdown = {}, None
    on_card = dev.type == "cuda"
    device = dict(platform="gpu" if on_card else "cpu",
                  kind=torch.cuda.get_device_name(dev) if on_card else "cpu", count=1,
                  memory_peak_bytes=int(out["memory_peak_bytes"]), **extra)
    judged = H.judge(out["checks"], cell.config["limits"])
    correct = H.passed(judged)
    card = H.card_line() if on_card else "cpu"
    print(json.dumps(dict(card=card, **out["info"])), file=sys.stderr)
    H.print_checks(judged)
    return H.result_line(correct, out["attempted"], out["failed"], metrics, device, judged,
                         breakdown), judged


if __name__ == "__main__":
    sys.exit(main())
