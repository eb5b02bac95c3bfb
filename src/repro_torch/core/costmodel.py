"""Analytical cost models, the port of ``repro/core/costmodel.py``.

1. The paper's dual-mode PE array / SRAM power model (§III-C, Fig. 11/12/16),
   calibrated against the paper's own measured points: pure arithmetic, the
   reference's to the last constant.

2. Roofline constants and the three-term roofline evaluator.  The
   reference's TPU v5e constants are kept under their names as its
   record; the port runs on one NVIDIA H100 SXM, whose published peaks
   (NVIDIA H100 Tensor Core GPU data sheet, SXM part, dense rates without
   sparsity, at the full 700 W) stand beside them.  ``roofline(...,
   chip=)`` picks the chip.
"""

from __future__ import annotations

from dataclasses import dataclass

# ---------------------------------------------------------------------------
# Chameleon ASIC model (calibrated to the paper's measured points)
# ---------------------------------------------------------------------------

# measured anchors (paper §IV):   16x16 @150 MHz -> 76.8 GOPS peak
PEAK_GOPS_16 = 76.8              # = 2 * 256 MACs * 150 MHz
F_MAX_HZ = 150e6
# Fig. 16 @0.73 V: 4x4 real-time KWS 3.1 uW total; 16x16 variant 7.4 uW
P_LEAK_CORE_AON_W = 1.5e-6       # core + always-on mem leakage (4x4 mode)
P_LEAK_MSB_W = 3.3e-6            # gateable MSB memory leakage (16x16 adds it)
E_DYN_PER_OP_J = 16e-15          # dynamic energy per (shift+add) op, 0.73 V


@dataclass(frozen=True)
class PEArrayMode:
    n: int  # array side (4 or 16)

    @property
    def macs(self) -> int:
        return self.n * self.n

    def peak_gops(self, f_hz: float = F_MAX_HZ) -> float:
        return 2 * self.macs * f_hz / 1e9

    def realtime_power_w(self, ops_per_s: float) -> float:
        """Leakage + dynamic power to sustain ops_per_s in real time."""
        leak = P_LEAK_CORE_AON_W + (P_LEAK_MSB_W if self.n > 4 else 0.0)
        return leak + E_DYN_PER_OP_J * ops_per_s

    def clock_for(self, ops_per_s: float) -> float:
        return ops_per_s / (2 * self.macs)


def kws_ops_per_s(macs_per_window: float, windows_per_s: float = 62.5) -> float:
    """Real-time KWS op rate (16 ms MFCC hop => 62.5 inferences/s)."""
    return 2.0 * macs_per_window * windows_per_s


# ---------------------------------------------------------------------------
# Roofline constants
# ---------------------------------------------------------------------------

# TPU v5e (the reference's record; nothing in the port runs on it)
PEAK_FLOPS_BF16 = 197e12   # per chip
HBM_BW = 819e9             # B/s per chip
ICI_BW = 50e9              # B/s per link (brief's constant)

# NVIDIA H100 SXM (data sheet): bf16 on the tensor cores, dense; fp32
# outside the tensor cores; HBM3
H100_PEAK_FLOPS_BF16 = 989e12
H100_PEAK_FLOPS_FP32 = 67e12
H100_HBM_BW = 3.35e12      # B/s
H100_NVLINK_BW = 900e9     # B/s per card, all links (NVLink 4)

CHIPS = {
    "tpu-v5e": (PEAK_FLOPS_BF16, HBM_BW, ICI_BW),
    "h100": (H100_PEAK_FLOPS_BF16, H100_HBM_BW, H100_NVLINK_BW),
}


@dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline(hlo_flops: float, hlo_bytes: float, collective_bytes: float,
             n_chips: int, chip: str = "tpu-v5e") -> RooflineTerms:
    """The three roofline terms on ``n_chips`` of ``chip`` (a key of
    ``CHIPS``): FLOPs at the bf16 peak, bytes at the memory rate,
    collective bytes at the link rate.  The default is the reference's
    chip, so a call without ``chip`` gives the reference's terms."""
    flops_s, mem_bw, link_bw = CHIPS[chip]
    return RooflineTerms(
        compute_s=hlo_flops / (n_chips * flops_s),
        memory_s=hlo_bytes / (n_chips * mem_bw),
        collective_s=collective_bytes / (n_chips * link_bw),
    )


def model_flops(n_params_active: float, n_tokens: float) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE)."""
    return 6.0 * n_params_active * n_tokens
