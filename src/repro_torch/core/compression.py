"""Δcut codec (paper §4.3). Port of `repro.core.compression`.

SH DC at fp16, SH AC vector-quantized against a k-means codebook fit
offline on the scene, position/log-scale/opacity at 16-bit fixed point, the
quaternion at 16 bits a component. The codeword assignment of `encode` and
of the k-means fit runs kernel K5 (`repro_torch.kernels.vq_assign`) on the
card.

The 16-bit unsigned fields (`pos_q`, `scale_q`, `opa_q`) are carried as
int32 tensors, since torch has no full uint16 arithmetic; the byte
accounting (`wire_bytes_per_gaussian`) counts the wire layout and never
looks at a dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.gaussians import Gaussians
from repro_torch.kernels.vq_assign import vq_assign
from repro_torch.numerics import div_rn, fma32, sqrt_rn


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


@dataclasses.dataclass(frozen=True)
class EncodedGaussians:
    dc: torch.Tensor        # (M, 3) float16
    code: torch.Tensor      # (M,) int32 — VQ index (wire width = codec.code_bytes())
    pos_q: torch.Tensor     # (M, 3) int32 holding uint16 codes
    scale_q: torch.Tensor   # (M, 3) int32 holding uint16 codes
    quat_q: torch.Tensor    # (M, 4) int16
    opa_q: torch.Tensor     # (M,) int32 holding uint16 codes

    @property
    def m(self) -> int:
        return self.dc.shape[0]


def wire_bytes_per_gaussian(codec: Codec) -> int:
    """16-bit attrs + fp16 DC + VQ code index (paper §4.3 layout)."""
    return 3 * 2 + codec.code_bytes() + 3 * 2 + 3 * 2 + 4 * 2 + 2


def _kmeans(x: torch.Tensor, init: torch.Tensor, iters: int) -> torch.Tensor:
    codebook = init
    k = codebook.shape[0]
    ones = torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
    for _ in range(iters):
        idx = vq_assign(x, codebook).long()
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


# ---------------------------------------------------------------------------
# encode / decode
# ---------------------------------------------------------------------------


def _quant16(x, lo, hi) -> torch.Tensor:
    hi_lo = torch.as_tensor(hi, dtype=torch.float32, device=x.device) - lo
    q = (x - lo) / torch.clamp_min(hi_lo, 1e-12) * 65535.0
    return torch.clamp(torch.round(q), 0, 65535).to(torch.int32)


def _dequant16(q, lo, hi) -> torch.Tensor:
    """q / 65535 · (hi − lo) + lo. The reference's compiler reassociates
    this expression, so decoded rows agree with it to a few ulp, not bit for
    bit (the encoded codes do)."""
    return div_rn(q.to(torch.float32), 65535.0) * (hi - lo) + lo


def _unit_quat(q: torch.Tensor) -> torch.Tensor:
    """q / (‖q‖ + 1e-12), the norm accumulated as the reference's compiled
    reduction rounds on the CPU: q0² → fma(q1,q1,·) → fma(q2,q2,·) →
    fma(q3,q3,·)."""
    s = q[:, 0] * q[:, 0]
    for i in (1, 2, 3):
        s = fma32(q[:, i], q[:, i], s)
    return q / (sqrt_rn(s)[:, None] + 1e-12)


def encode(codec: Codec, g: Gaussians) -> EncodedGaussians:
    n, k = g.sh.shape[0], g.sh.shape[1]
    if k > 1:
        code = vq_assign(g.sh[:, 1:, :].reshape(n, -1).contiguous(), codec.codebook)
    else:
        code = torch.zeros((n,), dtype=torch.int32, device=g.device)
    quat = _unit_quat(g.quat)
    return EncodedGaussians(
        dc=g.sh[:, 0, :].to(torch.float16),
        code=code,
        pos_q=_quant16(g.mu, codec.pos_lo, codec.pos_hi),
        scale_q=_quant16(g.log_scale, codec.scale_lo, codec.scale_hi),
        quat_q=torch.clamp(torch.round(quat * 32767.0), -32767, 32767).to(torch.int16),
        opa_q=_quant16(g.opacity, 0.0, 1.0),
    )


def decode(codec: Codec, e: EncodedGaussians, sh_k: int) -> Gaussians:
    m = e.m
    dc = e.dc.to(torch.float32)
    if sh_k > 1:
        ac = codec.codebook.index_select(0, e.code.long()).reshape(m, sh_k - 1, 3)
        sh = torch.cat([dc[:, None, :], ac], dim=1)
    else:
        sh = dc[:, None, :]
    quat = _unit_quat(div_rn(e.quat_q.to(torch.float32), 32767.0))
    return Gaussians(
        mu=_dequant16(e.pos_q, codec.pos_lo, codec.pos_hi),
        log_scale=_dequant16(e.scale_q, codec.scale_lo, codec.scale_hi),
        quat=quat,
        opacity=_dequant16(e.opa_q, 0.0, 1.0),
        sh=sh,
    )


def encode_rows(codec: Codec, g: Gaussians, ids: torch.Tensor) -> EncodedGaussians:
    """Gather rows `ids` (-1 padded → row 0) and encode them: the one gather +
    quantize/pack step of every wire path (the single-client unicast Δcut,
    the per-client reference encoder and the fleet's encode-once union)."""
    return encode(codec, g.slice_rows(ids.clamp_min(0)))


def roundtrip(codec: Codec, g: Gaussians) -> Gaussians:
    return decode(codec, encode(codec, g), g.sh.shape[1])


def max_position_error(codec: Codec) -> float:
    """Worst-case quantization error in meters (half an LSB per axis)."""
    rng = codec.pos_hi.cpu().numpy() - codec.pos_lo.cpu().numpy()
    return float(np.linalg.norm(rng / 65535.0 / 2.0))
