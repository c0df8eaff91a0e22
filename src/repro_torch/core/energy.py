"""Energy model for the client device (paper §6 / Fig. 19 methodology); a
copy of the JAX package's `core/energy.py`, kept here so that the port
imports nothing of it.

All constants are modeled (no RTL here): DRAM from Micron LPDDR3 power-calc
class numbers, compute from 8nm-scaled per-MAC energy used in the accelerator
literature the paper builds on (GSCore/GBU). Numbers are *relative* — a
benchmark reports ratios against the same model evaluated for the baselines,
mirroring how the paper normalizes Fig. 19 to its GPU baseline."""

from __future__ import annotations

import dataclasses

# modeled energy constants (J)
DRAM_J_PER_BYTE = 20e-12 * 8      # ~20 pJ/bit LPDDR3 access
SRAM_J_PER_BYTE = 1.2e-12 * 8     # on-chip buffer
MAC_J = 0.8e-12                   # 8nm fused MAC (bf16-class)
COMM_J_PER_BYTE = 100e-9          # wireless (paper §6)


@dataclasses.dataclass(frozen=True)
class EnergyBreakdown:
    dram_j: float
    sram_j: float
    compute_j: float
    comm_j: float

    @property
    def total_j(self) -> float:
        return self.dram_j + self.sram_j + self.compute_j + self.comm_j


def client_frame_energy(dram_bytes: float, sram_bytes: float, macs: float,
                        comm_bytes: float) -> EnergyBreakdown:
    return EnergyBreakdown(
        dram_j=dram_bytes * DRAM_J_PER_BYTE,
        sram_j=sram_bytes * SRAM_J_PER_BYTE,
        compute_j=macs * MAC_J,
        comm_j=comm_bytes * COMM_J_PER_BYTE,
    )
