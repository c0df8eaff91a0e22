"""K5 — vector-quantization codeword assignment (paper §4.3) on Hopper.

`vq_assign` launches `csrc/vq_assign.cu` (one thread per row, the codebook
in shared memory) for CUDA tensors and runs `vq_assign_plain` for CPU
tensors. Both compute argmin_k (‖c_k‖² − 2·x·c_k) with the first minimum
winning a tie, as the reference's Pallas kernel and its `vq_assign_ref`
oracle do. The plain version sums the dot product over d = 0..D−1 in order,
one elementwise product and add at a time (never `x @ codebook.T`, whose
summation order is cuBLAS's and may be TF32), which is the kernel's order,
so the two agree bit for bit on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

# SH AC widths the kernel is instantiated for: 1 (degree 0, the codec's
# placeholder column) and 3·((deg+1)²−1) for degrees 1–3.
KERNEL_DIMS = (1, 9, 24, 45)
MAX_SMEM_BYTES = 232448
_PLAIN_CHUNK = 1 << 16
_BLOCKS_PER_SM = 16
_THREADS = 256


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
    smem = lib.nebula_vq_assign_smem_bytes(kc, d)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"vq_assign: a {kc}x{d} codebook needs {smem} B of shared "
                         f"memory, more than the {MAX_SMEM_BYTES} B a block has")
    out = torch.empty((m,), dtype=torch.int32, device=dev)
    if m == 0:
        return out
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = min(-(-m // _THREADS), sms * _BLOCKS_PER_SM)
    p = _build.ptr
    err = lib.nebula_vq_assign(p(x), p(codebook), p(out), m, kc, d, blocks,
                               _build.stream_handle(dev))
    _build.check(err, "nebula_vq_assign")
    vq_assign.launches += 1
    return out


vq_assign.launches = 0
