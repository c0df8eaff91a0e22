"""Δcut codec: the part the session's wire format needs (paper §4.3).

Port of `repro.core.compression`, limited to the codec fit and the byte
accounting: SH DC at fp16, SH AC vector-quantized against a k-means
codebook, position/scale/opacity at 16-bit fixed point, the quaternion at
16 bits a component. The fit reaches no TPU kernel in the reference, so it
is plain PyTorch here. `encode`/`decode` (and their codeword-assignment
kernel) are not part of this port yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.gaussians import Gaussians


@dataclasses.dataclass(frozen=True)
class Codec:
    codebook: torch.Tensor     # (Kc, D) f32, D = (K-1)*3 SH AC dims (Kc>=1)
    pos_lo: torch.Tensor       # (3,)
    pos_hi: torch.Tensor       # (3,)
    scale_lo: torch.Tensor     # ()
    scale_hi: torch.Tensor     # ()

    @property
    def k_codes(self) -> int:
        return self.codebook.shape[0]

    def code_bytes(self) -> int:
        return max(1, int(np.ceil(np.log2(max(self.k_codes, 2)) / 8)))


def wire_bytes_per_gaussian(codec: Codec) -> int:
    """16-bit attrs + fp16 DC + VQ code index (paper §4.3 layout)."""
    return 3 * 2 + codec.code_bytes() + 3 * 2 + 3 * 2 + 4 * 2 + 2


def vq_assign_ref(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(M, D) × (Kc, D) → (M,) int32 nearest-codeword indices:
    argmin_k ||c_k||² − 2 x·c_k (first minimum wins a tie)."""
    c2 = (codebook * codebook).sum(-1)
    scores = c2[None, :] - 2.0 * (x @ codebook.T)
    return torch.argmin(scores, dim=-1).to(torch.int32)


def _kmeans(x: torch.Tensor, init: torch.Tensor, iters: int) -> torch.Tensor:
    codebook = init
    k = codebook.shape[0]
    ones = torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
    for _ in range(iters):
        idx = vq_assign_ref(x, codebook).long()
        sums = torch.zeros_like(codebook).index_add_(0, idx, x)
        cnts = torch.zeros((k,), dtype=x.dtype, device=x.device).index_add_(0, idx, ones)
        codebook = torch.where(cnts[:, None] > 0,
                               sums / torch.clamp_min(cnts[:, None], 1.0), codebook)
    return codebook


def fit_codec(g: Gaussians, k_codes: int = 256, iters: int = 8,
              seed: int = 0, sample: int = 65536) -> Codec:
    """Fit the codec on scene statistics (offline; cloud side), on the
    device of `g`. The sample and the initial codebook are drawn with numpy
    exactly as the reference draws them."""
    dev = g.device
    rng = np.random.default_rng(seed)
    n, k = g.sh.shape[0], g.sh.shape[1]
    d = max((k - 1) * 3, 1)
    if k > 1:
        ac = g.sh[:, 1:, :].reshape(n, -1).cpu().numpy()
    else:
        ac = np.zeros((n, 1), np.float32)
    take = rng.choice(n, size=min(sample, n), replace=False)
    xs = torch.as_tensor(ac[take], device=dev)
    init = torch.as_tensor(ac[rng.choice(n, size=min(k_codes, n), replace=False)],
                           device=dev)
    if init.shape[0] < k_codes:  # tiny scenes: tile
        reps = int(np.ceil(k_codes / init.shape[0]))
        init = init.repeat(reps, 1)[:k_codes]
        init = init + 1e-4 * torch.as_tensor(
            rng.normal(size=tuple(init.shape)).astype(np.float32), device=dev)
    codebook = _kmeans(xs, init, iters)

    mu = g.mu.cpu().numpy()
    ls = g.log_scale.cpu().numpy()
    pad = 1e-3
    return Codec(
        codebook=codebook.reshape(k_codes, d),
        pos_lo=torch.as_tensor(mu.min(0) - pad, device=dev),
        pos_hi=torch.as_tensor(mu.max(0) + pad, device=dev),
        scale_lo=torch.as_tensor(np.float32(ls.min() - pad), device=dev),
        scale_hi=torch.as_tensor(np.float32(ls.max() + pad), device=dev),
    )
