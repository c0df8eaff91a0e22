"""The port's `launch/` tooling: the cost analysis (`hlo_analysis`, the
five cases of `test_hlo_analysis.py` in torch terms: a traced eager run
counts every iteration, so the loop cases hold the counts exactly), the
H100 roofline, the report's tables, and a scaled-down dry-run
(`test_sharding.py::test_multi_device_dryrun_subprocess`): reduced
qwen2.5-3b, granite-moe and zamba2 × a train and a decode cell × a (2, 4)
and a (2, 2, 2) fake mesh, each process with a fake world of 8 ranks (the
default process group of this process stays free): one for the (2, 4)
mesh, and for the (2, 2, 2) mesh, where DTensor places each new op
signature in 0.1-0.6 s, one an arch (zamba2's two cells apart).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import dryrun, report, roofline
from repro_torch.launch.hlo_analysis import analyze


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


XS = (128, 128)


def test_loop_flops_count_every_iteration():
    def f(x, w):
        for _ in range(10):
            x = torch.tanh(x @ w)
        return x

    a = analyze(f, _meta(*XS), _meta(*XS))
    assert a["flops"] == 10 * 2 * 128 ** 3


def test_nested_loop_flops():
    def f(x, w):
        for _ in range(5):
            for _ in range(3):
                x = torch.tanh(x @ w)
        return x

    assert analyze(f, _meta(*XS), _meta(*XS))["flops"] == 15 * 2 * 128 ** 3


def test_gqa_einsum_flops():
    def f(q, k):
        return torch.einsum("bqhgd,bchd->bqhgc", q, k)

    a = analyze(f, _meta(2, 16, 4, 3, 8), _meta(2, 32, 4, 8))
    # out (2,16,4,3,32) × contracted 8 × 2
    assert a["flops"] == pytest.approx(2 * 16 * 4 * 3 * 32 * 8 * 2, rel=0.01)


def test_bytes_scale_with_trip_count():
    def mk(n):
        def f(x):
            for _ in range(n):
                x = torch.tanh(x * 2.0 + 1.0)
            return x
        return f

    a5 = analyze(mk(5), _meta(*XS))["hbm_bytes"]
    a50 = analyze(mk(50), _meta(*XS))["hbm_bytes"]
    assert a50 == 10 * a5 > 0


def test_dtype_sizes():
    def f(x):
        return x.to(torch.bfloat16) @ x.to(torch.bfloat16).T

    def g(x):
        return x @ x.T

    a = analyze(f, _meta(*XS))
    assert a["flops"] == 2 * 128 ** 3
    # the bf16 matmul moves half the f32 one's bytes; f also reads x twice
    # to cast it (f32 in, bf16 out)
    mm32 = analyze(g, _meta(*XS))["hbm_bytes"]
    assert mm32 == 3 * 128 * 128 * 4
    assert a["hbm_bytes"] == 2 * 128 * 128 * (4 + 2) + 3 * 128 * 128 * 2
    assert a["collective_bytes"] == 0 and a["all-gather_count"] == 0


def test_roofline_terms_h100():
    assert roofline.HW == dict(peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9)
    rec = dict(flops=989e12, bytes_accessed=6.7e12, collectives={"collective_bytes": 45e9},
               model_params_active=1e9, tokens=1000, mode="train", n_chips=4)
    rf = roofline.roofline_terms(rec)
    assert rf["compute_s"] == pytest.approx(1.0)
    assert rf["memory_s"] == pytest.approx(2.0)
    assert rf["collective_s"] == pytest.approx(0.1)
    assert rf["dominant"] == "memory"
    assert rf["model_flops"] == 6e12
    assert rf["useful_flops_ratio"] == pytest.approx(6e12 / (4 * 989e12))
    assert rf["roofline_fraction"] == pytest.approx(6e12 / 4 / 989e12 / 2.0)
    assert roofline.roofline_terms(dict(rec, mode="decode"))["model_flops"] == 2e12


def _ok_record(mesh="single", mem_gb=(10.0, 5.0, 1.0), mode="train"):
    rec = dict(arch="qwen2.5-3b", shape="train_4k", mesh=mesh, status="ok", mode=mode,
               tokens=1 << 20, n_chips=256, trace_s=12.3,
               memory=dict(argument_bytes=mem_gb[0] * 1e9, temp_bytes=mem_gb[1] * 1e9,
                           output_bytes=mem_gb[2] * 1e9, alias_bytes=0),
               flops=1e14, bytes_accessed=1e12,
               collectives={"all-gather_count": 3, "all-reduce_count": 0,
                            "reduce-scatter_count": 2, "collective_bytes": 4.5e10},
               model_params=3.4e9, model_params_active=3.4e9)
    rec["roofline"] = roofline.roofline_terms(rec)
    return rec


def test_report_tables():
    rows = [_ok_record(), _ok_record(mesh="multi"), _ok_record(mem_gb=(70.0, 9.0, 2.0)),
            dict(arch="gemma3-4b", shape="long_500k", mesh="single", status="skip",
                 reason="full-attention arch: 500k decode needs sub-quadratic attention"),
            dict(arch="xlstm-350m", shape="train_4k", mesh="single", status="error",
                 error="RuntimeError: something failed")]
    dry = report.dryrun_table(rows).splitlines()
    assert len(dry) == 2 + 5
    assert "| ok | 16.00 | 12 | all-gather×3 reduce-scatter×2 |" in dry[2]
    assert "ok ⚠>80GB | 81.00" in dry[4]
    assert "| SKIP |" in dry[5] and "| ERROR |" in dry[6]
    single = report.roofline_table(rows, "single").splitlines()
    multi = report.roofline_table(rows, "multi").splitlines()
    assert len(single) == 2 + 2 and len(multi) == 2 + 1
    assert "**memory**" in single[2]
    assert "bf16 intermediates" in single[2]
    assert report.fmt_s(0) == "0" and report.fmt_s(5e-5) == "50.0µs"
    assert report.fmt_s(0.05) == "50.00ms" and report.fmt_s(1.5) == "1.500s"
    assert report.HBM_PER_CHIP == 80e9


def test_returned_bytes_tell_updated_arguments_from_new_tensors():
    """A returned tensor that lies in an argument's storage (the argument
    itself, or a view of it as a cache written in place comes back) is an
    alias; anything else the step allocated. Object identity would call the
    view new."""
    cache, other = _meta(64, 32), _meta(8, 8)
    logits = _meta(4, 16)
    new, alias = dryrun._returned_bytes((logits, cache[:32], cache), (cache, other))
    assert (new, alias) == (4 * 16 * 4, (32 * 32 + 64 * 32) * 4)


TOY_ARCHS = ("qwen2.5-3b", "granite-moe-1b-a400m", "zamba2-2.7b")

_SUBPROC = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, "src")
import repro_torch.configs as C
import repro_torch.launch.dryrun as dr
import repro_torch.models.config as mc
from repro_torch.launch.mesh import init_fake_world, make_mesh
from repro_torch.models import model_zoo
from repro_torch.models.config import ShapeConfig, reduced
from repro_torch.sharding.partitioning import LOGICAL_RULES, make_shardings

torch.set_num_threads(1)
shapes = {"train_4k": ShapeConfig("train_4k", 64, 8, "train"),
          "decode_32k": ShapeConfig("decode_32k", 128, 8, "decode")}
mc.SHAPES = tuple(shapes.values())
dr.get_arch = lambda name: reduced(C.ARCHS[name])
init_fake_world(8)
meshes = [make_mesh((2, 4), ("data", "model")) if sys.argv[1] == "2" else
          make_mesh((2, 2, 2), ("pod", "data", "model"))]
archs, cells = sys.argv[2].split(","), sys.argv[3].split(",")


def spec_bytes(tree, specs, sizes):
    # a leaf's local bytes from its spec alone: each dim over its axes' sizes
    if isinstance(tree, dict):
        return sum(spec_bytes(tree[k], specs[k], sizes) for k in tree)
    if isinstance(tree, list):
        return sum(spec_bytes(a, b, sizes) for a, b in zip(tree, specs))
    if not torch.is_tensor(tree):
        return 0
    n = 1
    for dim, entry in zip(tree.shape, specs):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        n *= dim // int(np.prod([sizes[a] for a in axes]))
    return n * tree.element_size()


results = {}
for mesh in meshes:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    for arch in archs:
        cfg = reduced(C.ARCHS[arch])
        bundle = model_zoo.get_model(cfg)
        shp, ax = bundle.abstract_params()
        p_bytes = spec_bytes(shp, make_shardings(mesh, shp, ax), sizes)
        for name in cells:
            shape = shapes[name]
            rec = dr.trace_cell(arch, shape, mesh)
            specs = model_zoo.input_specs(cfg, shape)
            want = p_bytes + spec_bytes(specs, make_shardings(
                mesh, specs, model_zoo.batch_logical_axes(cfg, shape), dict(LOGICAL_RULES)), sizes)
            if shape.mode == "train":
                want += 2 * spec_bytes({k: v.float() for k, v in shp.items()},
                                       make_shardings(mesh, shp, ax), sizes) + 4
            else:
                cache, cax = bundle.abstract_cache(shape.global_batch, shape.seq_len)
                want += spec_bytes(cache, make_shardings(mesh, cache, cax), sizes)
            coll = sum(v for k, v in rec["collectives"].items() if k.endswith("_count"))
            results[f"{arch}|{name}|{len(mesh.mesh.shape)}"] = dict(
                ok=True, flops=rec["flops"], collectives=coll,
                argument_bytes=rec["memory"]["argument_bytes"], want_bytes=want,
                dominant=rec["roofline"]["dominant"])
print(json.dumps(results))
"""


def test_toy_dryrun_subprocess():
    """The (2, 4) mesh in one process and the (2, 2, 2) mesh in one process
    an arch (zamba2's train and decode cells apart: its train cell alone
    takes about 20 s), all at once, each its own fake world."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    both = "train_4k,decode_32k"
    jobs = [("2", ",".join(TOY_ARCHS), both), ("3", TOY_ARCHS[0], both),
            ("3", TOY_ARCHS[1], both), ("3", TOY_ARCHS[2], "train_4k"),
            ("3", TOY_ARCHS[2], "decode_32k")]
    procs = [subprocess.Popen([sys.executable, "-c", _SUBPROC, *job], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=root) for job in jobs]
    results = {}
    for p in procs:
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stderr[-3000:]
        results.update(json.loads(stdout.strip().splitlines()[-1]))
    assert len(results) == 12
    for key, r in results.items():
        assert r["ok"] and r["flops"] > 0, key
        assert r["argument_bytes"] == r["want_bytes"], (key, r)
        if "|train_4k|2" in key:
            assert r["collectives"] >= 1, key
