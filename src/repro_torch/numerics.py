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
    PyTorch divides by a host scalar as a multiply by its reciprocal."""
    if not torch.is_tensor(y):
        y = torch.tensor(y, dtype=x.dtype, device=x.device)
    return x / y
