"""Checkpointing: atomic, async, restored onto any device. Port of
`repro.checkpoint.manager`, with its on-disk layout, so that each package
reads the other's checkpoints.

Layout: <dir>/step_<N>/
  manifest.json   — leaf keys (the reference's path format), shapes, dtypes,
                    the leaf→file map, extras
  leaf_<i>.npy    — one file per leaf, in flatten order (`np.save`)

  * atomicity: write to step_<N>.tmp, fsync the manifest, rename — a killed
    save never corrupts the latest checkpoint;
  * async: a background thread writes (a save blocks only on the previous
    one); the copy to the host is made before the thread starts;
  * placement: restore() loads every leaf whole and puts it where the
    caller's skeleton (`like`) has it, or on `device` — the reference's
    reshard-on-load becomes a device move;
  * GC: keep-last-k, never under a concurrent reader.

Tensors are copied to the host with a blocking copy: a `non_blocking` one
returns before the card has written the host buffer.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import pytree

_MANIFEST = "manifest.json"
# numpy's own dtypes: what either package writes and reads without an
# extension module (the reference's bfloat16 needs `ml_dtypes`)
_NUMPY_DTYPES = frozenset({
    "bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "float16", "float32", "float64", "complex64", "complex128"})
_TORCH_DTYPES = frozenset({
    torch.bool, torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8,
    torch.float16, torch.float32, torch.float64, torch.complex64, torch.complex128})


class CheckpointDtypeError(TypeError):
    """A leaf whose dtype has no form both packages read (bfloat16: numpy
    has no such dtype without `ml_dtypes`)."""


def _numpy_dtype(name: str) -> np.dtype:
    if name not in _NUMPY_DTYPES:
        raise CheckpointDtypeError(f"dtype {name!r} has no numpy form both packages read")
    return np.dtype(name)


def _host_array(key: str, leaf) -> np.ndarray:
    """A C-ordered host copy of one leaf (never a view of the caller's
    buffer: an async save must not see later in-place writes)."""
    if torch.is_tensor(leaf):
        if leaf.dtype not in _TORCH_DTYPES:
            raise CheckpointDtypeError(f"leaf {key!r}: {leaf.dtype} has no numpy form "
                                       f"both packages read")
        t = leaf.detach().contiguous()
        return t.cpu().numpy() if t.device.type != "cpu" else t.numpy().copy()
    arr = np.array(leaf, order="C")
    _numpy_dtype(str(arr.dtype))
    return arr


def host_items(tree: Any) -> List[Tuple[str, np.ndarray]]:
    """[(key, host array)] of every leaf of `tree`, in flatten order."""
    return [(key, _host_array(key, leaf)) for key, leaf in pytree.flatten_with_paths(tree)]


def write_items(directory: str, step: int, items: List[Tuple[str, np.ndarray]],
                extras: Optional[Dict[str, Any]] = None) -> str:
    """Atomically write host `items` as checkpoint `step`. Returns the final
    path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "extras": extras or {}}
    for i, (key, arr) in enumerate(items):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({
            "key": key, "file": fname, "shape": list(arr.shape),
            "dtype": str(arr.dtype),
        })
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(directory: str, step: int, tree: Any,
         extras: Optional[Dict[str, Any]] = None) -> str:
    """Atomic synchronous save. Returns the final path."""
    return write_items(directory, step, host_items(tree), extras)


def _step_of(name: str) -> Optional[int]:
    """Parse a `step_<N>` directory name; None for anything else (torn
    `.tmp` leftovers, foreign files, non-integer suffixes), so discovery and
    GC survive junk in the checkpoint directory."""
    if not name.startswith("step_") or name.endswith(".tmp"):
        return None
    try:
        return int(name.split("_", 1)[1])
    except ValueError:
        return None


def valid_steps(directory: str) -> List[int]:
    """All complete (manifest-bearing) step numbers in `directory`,
    descending: the order recovery walks when the newest is torn."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        step = _step_of(name)
        if step is not None and os.path.exists(os.path.join(directory, name, _MANIFEST)):
            steps.append(step)
    return sorted(steps, reverse=True)


def latest_step(directory: str) -> Optional[int]:
    steps = valid_steps(directory)
    return steps[0] if steps else None


def load_leaves(path: str, manifest: Dict[str, Any], items) -> List[np.ndarray]:
    """Read the leaf files named by `manifest` for the `(key, like leaf)`
    `items`, each checked against its like leaf's shape and cast to the
    manifest's dtype (authoritative: a leaf file whose dtype drifted is
    cast back)."""
    by_key = {e["key"]: e for e in manifest["leaves"]}
    out = []
    for key, leaf in items:
        entry = by_key[key]
        arr = np.load(os.path.join(path, entry["file"]))
        expect = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != expect:
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {expect}")
        out.append(arr.astype(_numpy_dtype(entry["dtype"]), copy=False))
    return out


def place(like: Any, arrays: List[np.ndarray], device=None) -> Any:
    """`like` with its leaves replaced by host `arrays` (flatten order): a
    tensor where `like` has a tensor, on `device` or else on that tensor's
    device; a numpy array elsewhere."""
    target = None if device is None else torch.device(device)
    leaves = []
    for (_key, leaf), arr in zip(pytree.flatten_with_paths(like), arrays, strict=True):
        if torch.is_tensor(leaf):
            leaves.append(torch.from_numpy(arr).to(leaf.device if target is None else target))
        else:
            leaves.append(arr)
    return pytree.unflatten(like, leaves)


def restore(directory: str, step: int, like: Any, device=None) -> Any:
    """Restore checkpoint `step` into the structure of `like`. Tensor leaves
    go to `device` if given, else to the device of `like`'s leaf."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    items = pytree.flatten_with_paths(like)
    return place(like, load_leaves(path, manifest, items), device)


def read_extras(directory: str, step: int) -> Dict[str, Any]:
    path = os.path.join(directory, f"step_{step:08d}", _MANIFEST)
    with open(path) as f:
        return json.load(f)["extras"]


class CheckpointManager:
    """Async keep-last-k manager with crash-safe saves."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # steps a concurrent restore() is reading: _gc never deletes one,
        # even with keep=1
        self._lock = threading.Lock()
        self._reading: set = set()
        os.makedirs(directory, exist_ok=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree: Any, extras: Optional[Dict[str, Any]] = None):
        self.wait()
        # on the host BEFORE backgrounding: the caller may overwrite or free
        # the tensors as soon as this returns
        items = host_items(tree)

        def work():
            try:
                write_items(self.directory, step, items, extras)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(s for s in (_step_of(n) for n in os.listdir(self.directory))
                       if s is not None)
        with self._lock:
            protected = set(self._reading)
        for s in steps[: -self.keep]:
            if s in protected:
                continue
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    def latest(self) -> Optional[int]:
        self.wait()
        return latest_step(self.directory)

    def restore(self, like: Any, step: Optional[int] = None, device=None) -> Any:
        self.wait()
        step = latest_step(self.directory) if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        with self._lock:
            self._reading.add(step)
        try:
            return restore(self.directory, step, like, device)
        finally:
            with self._lock:
                self._reading.discard(step)
