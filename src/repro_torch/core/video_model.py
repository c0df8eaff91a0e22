"""Remote-rendering baseline models: H.265 video streaming + wireless link.
Port of `repro.core.video_model` (plain Python; no tensors).

The paper's Figs. 4/5/17/19 compare Nebula against streaming fully rendered
stereo video. The container has no NVENC/network, so (exactly like the paper's
own analytical treatment of the link) we model:

  * H.265 bitrate = bits-per-pixel preset × pixels × 2 eyes × FPS.
    Presets follow published HEVC operating points for high-motion content
    (Minallah'15 / Sullivan'12-class numbers):
      lossy-L   ≈ 0.05 bpp  (visible artifacts, ~35 dB)
      lossy-H   ≈ 0.15 bpp  (paper's default comparison point)
      lossless  ≈ 3.2  bpp
  * link: 100 Mbps high-speed Wi-Fi, 100 nJ/byte radio energy (paper §6).

Every consumer reports both bytes/frame and sustained bandwidth so Nebula's
Δcut traffic can be compared 1:1 (benchmarks/bench_bandwidth.py)."""

from __future__ import annotations

import dataclasses

H265_BPP = {"lossy-L": 0.05, "lossy-H": 0.15, "lossless": 3.2}
LINK_RATE_BPS = 100e6           # 100 Mbps Wi-Fi (paper §6)
COMM_ENERGY_J_PER_BYTE = 100e-9  # 100 nJ/B (paper §6, ISSCC'22 AR sensor study)
ENCODE_LATENCY_S = 4.0e-3        # HW HEVC encode (per stereo frame)
DECODE_LATENCY_S = 2.5e-3        # HW HEVC decode


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    width: int = 2064
    height: int = 2208
    fps: float = 90.0
    preset: str = "lossy-H"


def video_bytes_per_frame(cfg: StreamConfig) -> float:
    bpp = H265_BPP[cfg.preset]
    return bpp * cfg.width * cfg.height * 2 / 8.0  # stereo pair


def video_bandwidth_bps(cfg: StreamConfig) -> float:
    return video_bytes_per_frame(cfg) * 8.0 * cfg.fps


def video_frame_latency_s(cfg: StreamConfig, link_bps: float = LINK_RATE_BPS) -> float:
    """Motion-to-photon contribution of the streaming path for one frame."""
    tx = video_bytes_per_frame(cfg) * 8.0 / link_bps
    return ENCODE_LATENCY_S + tx + DECODE_LATENCY_S


def nebula_bandwidth_bps(sync_bytes_mean: float, w: int, fps: float) -> float:
    """Δcut traffic amortized over the w-frame sync interval + pose uplink."""
    from repro_torch.core.manager import POSE_UPLINK_BYTES
    per_frame = sync_bytes_mean / max(w, 1) + POSE_UPLINK_BYTES
    return per_frame * 8.0 * fps


def nebula_sync_latency_s(sync_bytes: float, link_bps: float = LINK_RATE_BPS) -> float:
    return sync_bytes * 8.0 / link_bps
