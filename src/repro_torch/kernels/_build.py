"""Builds and loads every `csrc/*.cu` kernel as one library.

At first use, one `nvcc` a source, all started together, compiles every
source to an object, and one more links them into
`build/repro_torch/libnebula_kernels.so` at the root of the checkout. The
build is redone when a source, a header they include (`csrc/sm90.cuh`:
the Hopper helpers of K7's forward and backward) or a flag changes. The
library has a plain C interface and is loaded with `ctypes`: every pointer
and the stream are `c_void_p`, strides `c_longlong`, and every entry point
returns `cudaGetLastError()`, which `check` turns into an exception.

Flags: `sm_90a`, `-O3`, no fast math and `--fmad=false`, because the α
test, `proj > τ`, the visibility bits and binning's precise cull are
decided by float rounding and the plain PyTorch versions do not contract
multiplies into adds. A missing `nvcc` or a failed build raises; nothing
falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "libnebula_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# C entry point → argument types (pointers and the stream are c_void_p,
# strides c_longlong).
SIGNATURES = {
    "nebula_lod_slab_sweep": [_P, _P, _P, _P, _P, _P, _P, _P, _F, _F,
                              _P, _P, _P, _I, _I, _I, _P],
    "nebula_lod_slab_sweep_smem_bytes": [_I],
    "nebula_lod_pair_sweep": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _F,
                              _P, _P, _P, _I, _I, _I, _P],
    "nebula_vq_assign": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    "nebula_vq_assign_smem_bytes": [_I, _I, _I],
    "nebula_preprocess": [*[_P] * 10, *[_F] * 7, _P, _P, _I, _I, _P],
    "nebula_stereo_merge": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "nebula_stereo_merge_smem_bytes": [_I, _I],
    "nebula_rasterize_slabs": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _I, _P],
    "nebula_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               *[_L] * 12, _I, _I, _F, _P, _I, _I, _I, _I, _P],
    "nebula_flash_attention_backward": [*[_P] * 14, *[_I] * 7, *[_L] * 24, _I, _I, _F,
                                        _P, _I, _P, _I, *[_I] * 8, _P],
    "nebula_bin_spans": [*[_P] * 5, *[_I] * 6, _P],
    "nebula_bin_count": [*[_P] * 6, _I, _L, _I, _I, _I, _P],
    "nebula_bin_emit": [*[_P] * 8, _I, _L, _I, _I, _I, _I, _P],
    "nebula_bin_sort": [_P, _P, _I, _I, _I, _P, _P, _P, _P],
    "nebula_bin_fill": [_P, _P, _L, _P, _L, _P, _P, _P, _I, _I, _I, _P],
}


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch cannot "
                       "be built (install the CUDA toolkit or put nvcc on PATH)")


def sources_digest(csrc: Path = CSRC) -> str:
    """The build's stamp: every `*.cu` source and every `*.cuh` header they
    include under `csrc`, by name and bytes, and the flags."""
    h = hashlib.sha256()
    for s in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()


def build() -> dict:
    """Build the library if its sources changed. Returns a report: {'path',
    'seconds', 'rebuilt', 'ptxas'} (ptxas: the compiler's register and
    shared-memory lines)."""
    sources = sorted(CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    log = BUILD_DIR / "build.log"
    digest = sources_digest()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return {"path": str(lib), "seconds": 0.0, "rebuilt": False,
                "ptxas": log.read_text() if log.exists() else ""}
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    objs = [BUILD_DIR / (src.stem + ".o") for src in sources]
    procs = [subprocess.Popen([nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    text = [p.communicate()[0] for p in procs]
    failed = [src.name for src, p in zip(sources, procs) if p.returncode != 0]
    if not failed:
        out = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", *[str(o) for o in objs],
                              "-o", str(lib)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        text.append(out.stdout)
        if out.returncode != 0:
            failed = ["(link)"]
    for obj in objs:   # only the library is kept: the stamp covers it alone
        obj.unlink(missing_ok=True)
    log.write_text("".join(text))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{''.join(text)}")
    stamp.write_text(digest)
    return {"path": str(lib), "seconds": time.perf_counter() - t0,
            "rebuilt": True, "ptxas": log.read_text()}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> int:
    return t.data_ptr()
