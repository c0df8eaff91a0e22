"""What the tools that run source trees in turns on one card share
(`k7_passes.py`, `train_step_ab.py`): each tree runs in a process of its
own (the tool's `--worker TREE`), which takes `chip_smoke` from this
checkout for shapes and timing and `repro_torch` from the tree, and builds
that tree's kernels into the tree's own `build/`."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def add_args(ap: argparse.ArgumentParser) -> None:
    """The options every such tool takes: trees, rounds, output, worker."""
    ap.add_argument("--tree", action="append", default=None,
                    help="a source tree to run (repeatable; default this checkout)")
    ap.add_argument("--rounds", type=int, default=1, help="A B B A rounds")
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)


def enter_tree(tree: Path):
    """In a worker: puts this checkout's `chip_smoke` and the tree's
    `repro_torch` on the path, checks that the package is the tree's,
    builds the tree's kernels and returns `chip_smoke`."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    assert Path(FA.__file__).resolve().is_relative_to(tree.resolve()), FA.__file__
    _build.build()
    return cs


def run_in_turns(script: str, trees: list, rounds: int, worker_args: list):
    """Runs `script --worker TREE *worker_args` for each tree in turns, A B
    B A for two, `rounds` times; yields (tree, the JSON of the run's last
    line of output). Fails if a run does."""
    trees = [Path(t).resolve() for t in (trees or [str(ROOT)])]
    order = []
    for _ in range(rounds):
        order += trees + trees[::-1] if len(trees) > 1 else trees
    for tree in order:
        out = subprocess.run([sys.executable, script, "--worker", str(tree), *worker_args],
                             capture_output=True, text=True, check=False)
        if out.returncode != 0:
            raise RuntimeError(f"{tree}: {out.stderr[-4000:]}")
        yield tree, json.loads(out.stdout.strip().splitlines()[-1])


def finish(out: str | None, key: str, records: list) -> None:
    """Prints the card's name and power limit and writes {"card", key:
    records} to `out`, where given."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    card = cs.card_line()
    print(card)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps({"card": card, key: records}, indent=1, default=str))
