"""float32 operations with a fixed rounding, for results decided by bits.

PyTorch's vectorized float32 `sqrt` on the CPU is not correctly rounded (it
differs from IEEE `sqrtf` in the last bit for about 1 value in 150), while
the CUDA kernels, the card's `torch.sqrt` and the reference all round
correctly. The LoD sweep's `proj > τ` and the visibility tests compare
values derived from such roots, so every plain version takes its roots from
`sqrt_rn`, and divides by Python numbers through `div_rn`.
"""

from __future__ import annotations

import torch


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (through float64: rounding a
    float64 root of a float32 to float32 is exact rounding)."""
    return torch.sqrt(x.double()).to(x.dtype)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fused multiply-add, via float64: a·b is exact in float64 and
    the sum is rounded to float64 and then to float32, which gives the fused
    result except where that double rounding lands on a float32 tie."""
    return (a.double() * b.double() + c.double()).float()


def div_rn(x: torch.Tensor, y) -> torch.Tensor:
    """x / y correctly rounded when y is a Python number too: on CUDA,
    PyTorch divides by a host scalar as a multiply by its reciprocal. The
    divisor is filled on x's device, which on the card copies nothing from
    the host and so does not wait on the stream."""
    if not torch.is_tensor(y):
        y = torch.full((), y, dtype=x.dtype, device=x.device)
    return x / y


_XLA_REDUCE_WINDOW = 32


def xla_row_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis in the order the reference's CPU
    backend takes it: a row longer than 32 is summed in windows of 32
    (zero-padded evenly at both ends), one element after another, and the
    window sums again so, until 32 or fewer remain, which are summed in
    order. Makes a float32 byte count come out as the same bits."""
    while x.shape[-1] > _XLA_REDUCE_WINDOW:
        n = x.shape[-1]
        n_out = -(-n // _XLA_REDUCE_WINDOW)
        pad = n_out * _XLA_REDUCE_WINDOW - n
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = x.reshape(x.shape[:-1] + (n_out, _XLA_REDUCE_WINDOW))
        x = _sequential_sum(x)
    return _sequential_sum(x)


def _sequential_sum(x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc
