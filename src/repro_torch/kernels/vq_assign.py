"""K5 — vector-quantization codeword assignment (paper §4.3) on Hopper.

`vq_assign` launches `csrc/vq_assign.cu` for CUDA tensors and runs
`vq_assign_plain` for CPU tensors. Both compute argmin_k (‖c_k‖² − 2·x·c_k)
with the first minimum winning a tie, as the reference's Pallas kernel and
its `vq_assign_ref` oracle do. The plain version sums the dot product over
d = 0..D−1 in order, one elementwise product and add at a time (never
`x @ codebook.T`, whose summation order is cuBLAS's and may be TF32). The
kernel scores every code on the tensor cores in TF32 only to filter: with a
rigorous bound on the TF32 error it keeps the codes that could be a row's
minimum. Where that is one code, it is the answer; else those codes are
scored again in the plain version's order. So the two agree bit for bit
on the card. Rows the filter cannot bound (a non-finite
or huge value, a non-finite or huge codebook, D = 1, a codebook too large
for the filter's shared memory) take the plain scan over every code.
`filter_counts` reads, on request, how many rows took each way and how
many candidates the filter left.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

# SH AC widths the kernel is instantiated for: 1 (degree 0, the codec's
# placeholder column) and 3·((deg+1)²−1) for degrees 1–3.
KERNEL_DIMS = (1, 9, 24, 45)
MAX_SMEM_BYTES = 232448
# the kernel's counters (csrc/vq_assign.cu's `Counter`, in its order): rows
# the filter took, rows the plain scan took, codes within the filter's
# bound (one for a row its first pass settles), the most such codes of one
# row, rows its second pass took
COUNTERS = ("filtered", "scanned", "candidates", "most_candidates", "second_pass")
_PLAIN_CHUNK = 1 << 16
_counters = {}   # device → int64 (len(COUNTERS),)


def codeword_norms(codebook: torch.Tensor) -> torch.Tensor:
    """‖c_k‖², summed over d in order (the kernel's order)."""
    c2 = codebook[:, 0] * codebook[:, 0]
    for d in range(1, codebook.shape[1]):
        c2 = c2 + codebook[:, d] * codebook[:, d]
    return c2


def vq_assign_plain(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(M, D) × (Kc, D) → (M,) int32 nearest-codeword indices. Rows go in
    chunks, so the (chunk, Kc) score block stays small."""
    m, d = x.shape
    c2 = codeword_norms(codebook)
    out = torch.empty((m,), dtype=torch.int32, device=x.device)
    for lo in range(0, m, _PLAIN_CHUNK):
        xs = x[lo:lo + _PLAIN_CHUNK]
        dot = xs[:, 0:1] * codebook[None, :, 0]
        for j in range(1, d):
            dot = dot + xs[:, j:j + 1] * codebook[None, :, j]
        out[lo:lo + _PLAIN_CHUNK] = torch.argmin(c2[None, :] - 2.0 * dot, dim=1)
    return out


def _device_counters(dev: torch.device) -> torch.Tensor:
    key = (dev.type, dev.index if dev.index is not None else torch.cuda.current_device())
    if key not in _counters:
        _counters[key] = torch.zeros(len(COUNTERS), dtype=torch.int64, device=dev)
    return _counters[key]


def filter_counts(device="cuda") -> dict:
    """The kernel's counters (`COUNTERS`) on `device` since the last reset.
    Reading them waits for the device."""
    vals = _device_counters(torch.device(device)).tolist()
    return dict(zip(COUNTERS, vals))


def reset_filter_counts(device="cuda") -> None:
    _device_counters(torch.device(device)).zero_()


def vq_assign(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest codeword of every row: (M,) int32. CPU tensors run the plain
    version; CUDA tensors launch K5."""
    dev = x.device
    if dev.type == "cpu":
        return vq_assign_plain(x, codebook)
    if dev.type != "cuda":
        raise ValueError(f"vq_assign: unsupported device {dev}")
    m, d = x.shape
    kc = codebook.shape[0]
    for name, t, shape in (("x", x, (m, d)), ("codebook", codebook, (kc, d))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"vq_assign: {name} must be float32 {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"vq_assign: {name} must be contiguous")
    if d not in KERNEL_DIMS:
        raise ValueError(f"vq_assign: the kernel takes rows of {KERNEL_DIMS} floats, "
                         f"got {d}")
    if kc < 1:
        raise ValueError("vq_assign: empty codebook")
    lib = _build.library()
    use_filter = d > 1 and lib.nebula_vq_assign_smem_bytes(kc, d, 1) <= MAX_SMEM_BYTES
    smem = lib.nebula_vq_assign_smem_bytes(kc, d, int(use_filter))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"vq_assign: a {kc}x{d} codebook needs {smem} B of shared "
                         f"memory, more than the {MAX_SMEM_BYTES} B a block has")
    out = torch.empty((m,), dtype=torch.int32, device=dev)
    if m == 0:
        return out
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p = _build.ptr
    err = lib.nebula_vq_assign(p(x), p(codebook), p(out), m, kc, d, int(use_filter), sms,
                               int(x.data_ptr() % 16 == 0), p(_device_counters(dev)),
                               _build.stream_handle(dev))
    _build.check(err, "nebula_vq_assign")
    vq_assign.launches += 1
    return out


vq_assign.launches = 0
