"""The command as the benchmark's check runs it. Without a card it exits
with another code than 0 and prints no result; on the card (the `cuda`
marker) a short run of a cell prints a correct result line."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


def command(*extra):
    return [sys.executable, "nebula_bench/run.py", "--workload", "city24-quest3.walk",
            "--seed", "2147483659", *extra]


def test_without_a_card_it_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(command("--seconds", "1"), cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload,trace", [("city24-quest3.walk", "0"),
                                            ("city24-fleet16.walk", "1")])
def test_a_short_run_on_the_card_is_correct(workload, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = command("--seconds", "5", "--trace", trace)
    args[3] = workload
    out = subprocess.run(args, cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
