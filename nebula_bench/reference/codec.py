"""The Δcut codec (paper §4.3), as the configuration states it.

Fit, once a scene: the SH AC of 65,536 rows drawn with numpy's generator at
seed 0 (then 256 more for the initial codebook), and 6 rounds of k-means,
each assigning a row its nearest codeword by ‖c‖² − 2·x·c (the first of
equal scores) and moving every used codeword to its rows' mean. Position
bounds: the scene's extremes ∓ 1e-3; log-scale bounds likewise over all
three axes.

A row on the wire: position, log-scale and opacity as 16-bit fractions of
their bounds (rounded, clamped), the unit quaternion at 16 bits a
component (×32767), the SH DC at fp16 and the code of its SH AC. Decoding
reverses each step."""

from __future__ import annotations

import numpy as np
import torch


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """A divisor on the device: CUDA divides by a host number as a multiply
    by its reciprocal, which is not the correctly rounded quotient."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


class Codec:
    def __init__(self, padded: dict, device, dtype=torch.float32, k_codes: int = 256,
                 iters: int = 6, sample: int = 65536):
        self.dtype = dtype
        sh = padded["sh"]
        n, k = sh.shape[0], sh.shape[1]
        self.sh_k = k
        ac = sh[:, 1:, :].reshape(n, -1) if k > 1 else np.zeros((n, 1), np.float32)
        rng = np.random.default_rng(0)
        take = rng.choice(n, size=min(sample, n), replace=False)
        xs = torch.as_tensor(ac[take], device=device).to(dtype)
        book = torch.as_tensor(ac[rng.choice(n, size=min(k_codes, n), replace=False)],
                               device=device).to(dtype)
        for _ in range(iters):
            idx = self.assign(xs, book)
            sums = torch.zeros_like(book, dtype=torch.float32).index_add_(0, idx, xs.float())
            cnts = torch.zeros(book.shape[0], device=device).index_add_(
                0, idx, torch.ones(xs.shape[0], device=device))
            book = torch.where(cnts[:, None] > 0, sums / cnts.clamp_min(1.0)[:, None],
                               book.float()).to(dtype)
        self.codebook = book
        mu, ls = padded["mu"], padded["log_scale"]
        pad = 1e-3
        self.pos_lo = torch.as_tensor(mu.min(0) - pad, device=device).to(dtype)
        self.pos_hi = torch.as_tensor(mu.max(0) + pad, device=device).to(dtype)
        self.scale_lo = torch.tensor(float(np.float32(ls.min() - pad)), device=device).to(dtype)
        self.scale_hi = torch.tensor(float(np.float32(ls.max() + pad)), device=device).to(dtype)

    @staticmethod
    def assign(x: torch.Tensor, book: torch.Tensor, chunk: int = 1 << 16) -> torch.Tensor:
        c2 = book[:, 0] * book[:, 0]
        for d in range(1, book.shape[1]):
            c2 = c2 + book[:, d] * book[:, d]
        out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
        for lo in range(0, x.shape[0], chunk):
            xs = x[lo:lo + chunk]
            dot = xs[:, 0:1] * book[None, :, 0]
            for d in range(1, book.shape[1]):
                dot = dot + xs[:, d:d + 1] * book[None, :, d]
            out[lo:lo + chunk] = torch.argmin(c2[None, :] - 2.0 * dot, dim=1)
        return out

    def _q16(self, x, lo, hi):
        q = (x - lo) / torch.clamp_min(hi - lo, 1e-12) * 65535.0
        return torch.clamp(torch.round(q.float()), 0, 65535)

    def _dq16(self, q, lo, hi):
        return (q.to(self.dtype) / _scalar(65535.0, q)) * (hi - lo) + lo

    def roundtrip(self, rows: dict) -> dict:
        """Rows (a dict of float32 tensors: mu, log_scale, quat, opacity, sh)
        as the client decodes them after the wire."""
        dt = self.dtype
        n = rows["mu"].shape[0]
        sh = rows["sh"].to(dt)
        mu, ls, op = rows["mu"].to(dt), rows["log_scale"].to(dt), rows["opacity"].to(dt)
        q = rows["quat"].to(dt)
        q = q / (torch.sqrt((q * q).sum(1, keepdim=True)) + 1e-12)
        quat_q = torch.clamp(torch.round(q.float() * 32767.0), -32767, 32767)
        qd = (quat_q / _scalar(32767.0, quat_q)).to(dt)
        qd = qd / (torch.sqrt((qd * qd).sum(1, keepdim=True)) + 1e-12)
        if self.sh_k > 1:
            code = self.assign(sh[:, 1:, :].reshape(n, (self.sh_k - 1) * 3), self.codebook)
            ac = self.codebook[code].reshape(n, self.sh_k - 1, 3)
            sh_out = torch.cat([sh[:, :1, :].half().to(dt), ac], 1)
        else:
            sh_out = sh[:, :1, :].half().to(dt)
        zero, one = torch.zeros((), device=mu.device), torch.ones((), device=mu.device)
        return dict(mu=self._dq16(self._q16(mu, self.pos_lo, self.pos_hi), self.pos_lo,
                                  self.pos_hi),
                    log_scale=self._dq16(self._q16(ls, self.scale_lo, self.scale_hi),
                                         self.scale_lo, self.scale_hi),
                    quat=qd, opacity=self._dq16(self._q16(op, zero, one), zero.to(dt),
                                                one.to(dt)),
                    sh=sh_out)
