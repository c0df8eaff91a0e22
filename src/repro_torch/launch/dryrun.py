"""Multi-pod dry-run: every (arch × shape × mesh) cell traced on the
production meshes with full shardings, on no device: the port of
`repro.launch.dryrun`.

The reference requests 512 placeholder CPU devices before JAX starts,
lowers and compiles each cell with XLA, and reads its memory and cost
analyses. The port starts a fake world of 256 or 512 ranks in this process
(`launch.mesh.init_fake_world`: collectives move nothing), builds the
model on the meta device, places its parameters, the optimizer state, the
batch and the cache as DTensors by `make_shardings` on the fake mesh, and
runs the step once under `activation_rules(mesh)` inside
`hlo_analysis.analyze`, which counts what one rank executes:
  train   — the train step, `compress_grads=False` as in the reference;
  prefill — the prefill of the whole batch;
  decode  — one token against a `seq_len` cache.

Each cell's record has the reference's keys. `memory`:
  argument_bytes — exact: the local shard bytes of the parameters, the
                   optimizer state, the batch and the cache;
  temp_bytes     — an estimate: the most bytes the step's own tensors held
                   at once (`peak_live_bytes`), outputs included;
  output_bytes   — exact for what the step returns that it allocated;
  alias_bytes    — exact: what it returns that it updated in place (the
                   parameters and moments of a train step, a decode's cache).
`flops`, `bytes_accessed` and `collectives` come from `hlo_analysis`
(`bytes_accessed` is an upper bound: eager ops are not fused);
`roofline` from `roofline.roofline_terms`. The reference's
`xla_flops_looponce` (XLA's count of a loop body once) has no counterpart.

Usage (no card and no JAX needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
      --mesh both --out experiments/dryrun
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch.hlo_analysis import analyze
from repro_torch.launch.mesh import init_fake_world, make_production_mesh
from repro_torch.launch.roofline import roofline_terms
from repro_torch.models.config import SHAPES, ShapeConfig, get_shape, long_context_capable
from repro_torch.models.model_zoo import batch_logical_axes, get_model, input_specs
from repro_torch.models.layers import param_axes
from repro_torch.sharding.context import activation_rules, meshed
from repro_torch.sharding.partitioning import (LOGICAL_RULES, make_shardings, shard_module,
                                               shard_tree)
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step


def skip_reason(cfg, shape: ShapeConfig) -> str | None:
    if shape.name == "long_500k" and not long_context_capable(cfg):
        return ("full-attention arch: 500k decode needs sub-quadratic "
                "attention (DESIGN.md §4)")
    return None


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def local_bytes(tree) -> int:
    """Bytes this rank holds of every tensor leaf of `tree` (a DTensor's
    local shard)."""
    return sum(_local(t).numel() * _local(t).element_size() for t in _tensors(tree))


def _batch(mesh, cfg, shape):
    specs = input_specs(cfg, shape)
    return shard_tree(specs, mesh, make_shardings(mesh, specs, batch_logical_axes(cfg, shape),
                                                  dict(LOGICAL_RULES)))


def lower_cell(arch: str, shape, mesh):
    """Build one (arch × shape) cell on `mesh` (`shape`: a cell's name or a
    `ShapeConfig`) on the meta device: the model's parameters placed by
    `make_shardings` and the step's other arguments. → (step, args,
    meta): run `step(*args)` under `meshed(activation_rules(mesh))`; meta
    holds the mode, the tokens and `argument_bytes`."""
    cfg = get_arch(arch)
    shape = get_shape(shape) if isinstance(shape, str) else shape
    model = get_model(cfg)
    module = model.init(seed=0, device="meta")
    specs = make_shardings(mesh, dict(module.named_parameters()), param_axes(module))
    shard_module(module, mesh, specs)
    batch = _batch(mesh, cfg, shape)

    if shape.mode == "train":
        ostate = opt.AdamWState(
            step=torch.zeros((), dtype=torch.int32, device="meta"),
            m=shard_tree(_moments(module), mesh, specs),
            v=shard_tree(_moments(module), mesh, specs))
        step = make_train_step(model, opt.OptimizerConfig(), compress_grads=False)
        args = (module, ostate, None, batch)
        nbytes = local_bytes([dict(module.named_parameters()), ostate, batch])
        return step, args, dict(mode="train", tokens=shape.tokens, argument_bytes=nbytes)

    if shape.mode == "prefill":
        args = (module, batch)
        nbytes = local_bytes([dict(module.named_parameters()), batch])
        return model.prefill, args, dict(mode="prefill", tokens=shape.tokens,
                                         argument_bytes=nbytes)

    # decode: one token against a seq_len cache
    cache, cache_axes = model.abstract_cache(shape.global_batch, shape.seq_len)
    cache = shard_tree(cache, mesh, make_shardings(mesh, cache, cache_axes))
    args = (module, cache, batch)
    nbytes = local_bytes([dict(module.named_parameters()), cache, batch])
    return model.decode_step, args, dict(mode="decode", tokens=shape.global_batch,
                                         argument_bytes=nbytes)


def trace_cell(arch: str, shape, mesh) -> dict:
    """Build and trace one cell on `mesh` → the record's measured fields
    (mode, tokens, n_chips, lower_s, trace_s, memory, flops,
    bytes_accessed, collectives, model_params, model_params_active,
    roofline)."""
    cfg = get_arch(arch)
    t0 = time.time()
    step, args, meta = lower_cell(arch, shape, mesh)
    t_lower = time.time() - t0
    returned = {}

    def run():
        out = step(*args)
        returned["bytes"] = _returned_bytes(out, args)
        return out

    with meshed(activation_rules(mesh)):
        ana = analyze(run)
    t_trace = time.time() - t0 - t_lower
    out_bytes, alias_bytes = returned["bytes"]
    rec = dict(
        mode=meta["mode"], tokens=meta["tokens"],
        n_chips=int(np.prod(mesh.mesh.shape)),
        lower_s=round(t_lower, 2),
        trace_s=round(t_trace, 2),
        memory=dict(
            argument_bytes=int(meta["argument_bytes"]),
            output_bytes=int(out_bytes),
            temp_bytes=int(ana["peak_live_bytes"]),
            alias_bytes=int(alias_bytes),
        ),
        flops=float(ana["flops"]),
        bytes_accessed=float(ana["hbm_bytes"]),
        collectives={k: v for k, v in ana.items()
                     if k.endswith("_bytes") or k.endswith("_count")},
        model_params=cfg.param_count,
        model_params_active=cfg.active_param_count,
    )
    rec["roofline"] = roofline_terms(rec)
    return rec


def _moments(module):
    """A float32 moment of each parameter's global shape, on the meta device."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device="meta")
            for n, p in module.named_parameters()}


def _returned_bytes(out, args) -> tuple:
    """(bytes of returned tensors the step allocated, bytes of returned
    tensors it updated in place), on this rank. A returned tensor is an
    argument updated in place when it lies in an argument's storage (a
    DTensor's `to_local` may be a new view object each call, so object
    identity would not tell)."""
    held = {_local(t).untyped_storage()._cdata for t in _tensors(args)}
    new = alias = 0
    for t in _tensors(out):
        loc = _local(t)
        n = loc.numel() * loc.element_size()
        if loc.untyped_storage()._cdata in held:
            alias += n
        else:
            new += n
    return new, alias


def _tensors(tree):
    """Every tensor of a tree of dicts, lists, tuples, optimizer states and
    modules (their parameters)."""
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, opt.AdamWState):
        yield from _tensors([tree.step, tree.m, tree.v])
    elif torch.is_tensor(tree):
        yield tree


def fake_world(n_chips: int) -> None:
    """Make the default process group a fake world of `n_chips` ranks."""
    if dist.is_initialized():
        if dist.get_world_size() == n_chips and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    init_fake_world(n_chips)


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             skip_existing: bool = True) -> dict:
    out_path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}.json")
    if skip_existing and os.path.exists(out_path):
        with open(out_path) as f:
            return json.load(f)

    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    rec = dict(arch=arch, shape=shape_name, mesh=mesh_kind, status="ok")

    reason = skip_reason(cfg, shape)
    if reason:
        rec.update(status="skip", reason=reason)
        _write(out_path, rec)
        return rec

    multi = mesh_kind == "multi"
    try:
        fake_world(512 if multi else 256)
        rec.update(trace_cell(arch, shape_name, make_production_mesh(multi_pod=multi)))
    except Exception as e:  # record the failure: these are faults to fix
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    _write(out_path, rec)
    return rec


def _write(path: str, rec: dict):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    shapes = [s.name for s in SHAPES] if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    n_ok = n_skip = n_err = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                rec = run_cell(arch, shape, mesh_kind, args.out, skip_existing=not args.force)
                tag = rec["status"]
                if tag == "ok":
                    n_ok += 1
                    mem_gb = (rec["memory"]["argument_bytes"]
                              + rec["memory"]["temp_bytes"]) / 1e9
                    print(f"[ok]   {arch:24s} {shape:12s} {mesh_kind:6s} "
                          f"mem/dev={mem_gb:6.2f}GB flops={rec['flops']:.3e} "
                          f"trace={rec['trace_s']:.1f}s", flush=True)
                elif tag == "skip":
                    n_skip += 1
                    print(f"[skip] {arch:24s} {shape:12s} {mesh_kind:6s} "
                          f"({rec['reason'][:60]})", flush=True)
                else:
                    n_err += 1
                    print(f"[ERR]  {arch:24s} {shape:12s} {mesh_kind:6s} "
                          f"{rec['error'][:120]}", flush=True)
    print(f"\ndone: {n_ok} ok, {n_skip} skip, {n_err} errors")
    if dist.is_initialized():
        dist.destroy_process_group()
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
