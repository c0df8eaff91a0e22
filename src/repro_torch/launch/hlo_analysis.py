"""Per-device cost analysis of one traced call: the counterpart of
`repro.launch.hlo_analysis`. There is no HLO here.

The reference compiles a step with XLA and parses the per-device SPMD
module's text, recovering scan trip counts from the loop conditions. The
port runs the step once, eagerly, under a `TorchDispatchMode`, on meta
tensors (or DTensors of meta shards on a fake world, `launch/mesh.py`),
and counts what each rank would execute. Ops on DTensors are passed down
(`NotImplemented`), so DTensor lowers them to the local ops and the
collectives of one rank, and those are what the mode counts. The eager
loop runs every layer, so there is no trip count to recover.

Metrics (JAX's keys):
  flops      — `torch.utils.flop_counter`'s formula of each local op
               (2·M·N·K for a matmul);
  hbm_bytes  — operand plus result bytes of each local op that is not a
               view. The ops are not fused, so this is an upper bound of
               XLA's post-fusion count;
  collective — result bytes and count per collective kind, from the
               `c10d_functional` ops DTensor issues: all-gather,
               all-reduce, reduce-scatter, all-to-all, collective-permute
               (none issue it) and broadcast.
  peak_live_bytes — the most bytes held at once by tensors the call
               created (weak references on each new storage): an estimate
               of the step's temporaries beyond its arguments.

The sharding propagation's own shape inference (fake tensors at global
shapes) is not counted.
"""

from __future__ import annotations

import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast")

_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "_c10d_functional_autograd")
_FREE_OPS = {"wait_tensor", "_wrap_tensor_autograd", "empty", "empty_strided", "empty_like",
             "detach", "lift_fresh", "alias"}
# ops that read only their operand's shape and type: their result is written, nothing read
_WRITE_ONLY = {"new_zeros", "new_ones", "new_full", "new_empty", "zeros_like", "ones_like",
               "full_like"}


def _tensors(tree, out=None) -> list:
    """The tensors of an op's arguments or results (tuples, lists and
    dicts of them)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts the local ops run inside it (module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.coll_bytes = {k: 0.0 for k in COLLECTIVES}
        self.coll_count = {k: 0 for k in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._alive: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._alive.pop(key, 0)

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._alive:
                continue
            self._alive[key] = st.nbytes()
            self.live += st.nbytes()
            weakref.finalize(t, self._free, key)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out                      # DTensor's shape inference, not a rank's op
        packet = getattr(func, "_overloadpacket", None)
        ns = getattr(func, "namespace", "")
        name = packet.__name__ if packet is not None else ""
        if ns in _COLLECTIVE_NS:
            kind = _KIND.get(name)
            if kind is not None:
                self.coll_bytes[kind] += sum(_nbytes(t) for t in _tensors(out))
                self.coll_count[kind] += 1
            self._track(out)
            return out
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs, out_val=out))
        if name not in _FREE_OPS and not getattr(func, "is_view", False):
            if name not in _WRITE_ONLY:
                self.hbm_bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.hbm_bytes += sum(_nbytes(t) for t in _tensors(out))
            self._track(out)
        return out

    def result(self) -> Dict[str, float]:
        out = dict(flops=self.flops, hbm_bytes=self.hbm_bytes,
                   collective_bytes=sum(self.coll_bytes.values()))
        for k in COLLECTIVES:
            out[f"{k}_bytes"] = self.coll_bytes[k]
            out[f"{k}_count"] = self.coll_count[k]
        out["peak_live_bytes"] = float(self.peak)
        return out


def analyze(fn, *args, **kwargs) -> Dict[str, float]:
    """Run `fn(*args, **kwargs)` once under `CostMode` → JAX's keys
    (flops, hbm_bytes, collective_bytes, each kind's `_bytes` and
    `_count`) and `peak_live_bytes`."""
    mode = CostMode()
    with mode:
        out = fn(*args, **kwargs)
        del out
    return mode.result()
