"""Roofline terms of a dry-run cell: the port of `repro.launch.roofline`,
with an NVIDIA H100's constants in place of the TPU v5e's.

Three terms per (arch × shape × mesh), each in seconds of one device:
  compute    = flops / peak_flops            (the per-device count)
  memory     = bytes_accessed / hbm_bw
  collective = collective_bytes / link_bw

The constants are the data-sheet peaks of the card the port runs on,
`nvidia-smi --query-gpu=name,power.limit` giving "NVIDIA H100 80GB HBM3,
700.00 W": dense bf16 tensor-core math, HBM3, and NVLink 4 (900 GB/s a
card both ways, 450 each way). Like the reference's, this roofline has one
link bandwidth: on the multi-pod mesh the `pod` axis would cross
InfiniBand between hosts, not NVLink. A card run below 700 W reaches less.

The reference also parses collective bytes out of compiled HLO text
(`collective_bytes_from_hlo`); the port counts them as DTensor issues them
(`launch/hlo_analysis.py`), so that function has no counterpart here.
"""

from __future__ import annotations

# NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, per card
HW = dict(
    peak_flops=989e12,      # bf16 dense FLOP/s
    hbm_bw=3.35e12,         # B/s
    link_bw=450e9,          # B/s, NVLink each way
)


def roofline_terms(rec: dict) -> dict:
    """The three roofline terms (seconds) and the bottleneck of a cell
    record from `launch/dryrun.py`."""
    flops = rec.get("flops", 0.0)
    byts = rec.get("bytes_accessed", 0.0)
    coll = rec.get("collectives", {}).get("collective_bytes", 0.0)
    t_compute = flops / HW["peak_flops"]
    t_memory = byts / HW["hbm_bw"]
    t_coll = coll / HW["link_bw"]
    terms = {"compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll}
    dominant = max(terms, key=terms.get)

    # MODEL_FLOPS: 6·N·D train (N = active params, D = tokens); 2·N·D fwd-only
    n_active = rec.get("model_params_active", 0)
    tokens = rec.get("tokens", 0)
    factor = 6 if rec.get("mode", "train") == "train" else 2
    model_flops = factor * n_active * tokens
    n_chips = max(rec.get("n_chips", 1), 1)
    flops_global = flops * n_chips       # the count is per device
    useful = model_flops / flops_global if flops_global else 0.0

    bound = max(t_compute, t_memory, t_coll)
    ideal = model_flops / n_chips / HW["peak_flops"]
    return dict(
        terms, dominant=dominant.replace("_s", ""),
        model_flops=model_flops,
        useful_flops_ratio=useful,
        roofline_fraction=(ideal / bound) if bound > 0 else 0.0,
    )
