"""Resource models: the paper's FPGA devices.

SMOF's constraints (Eq. 7) are expressed against a device budget of
compute units, on-chip memory bits, and off-chip bandwidth.  The instances
are the four AMD FPGA devices used in the paper's evaluation (§V), with
DSP / BRAM18K / URAM / LUT / DDR-bandwidth budgets.  They are the DSE's
target sheets; where the tensors of a lowered plan live is a separate
choice (``CompileSpec.torch_device``).
"""
from __future__ import annotations

import dataclasses

BRAM18K_BITS = 18 * 1024
URAM_BITS = 288 * 1024


@dataclasses.dataclass(frozen=True)
class Device:
    """A SMOF-visible resource budget.

    compute_units:   MACs/cycle available (DSPs on FPGA).
    onchip_bits:     total "on-chip" storage in bits (BRAM+URAM).
    offchip_gbps:    usable "off-chip" bandwidth, Gbit/s (DDR / HBM / PCIe).
    luts:            logic budget; codecs charge against it (FPGA only —
                     TPU views set it to 0 and codec cost becomes compute).
    freq_mhz:        pipeline clock.
    reconfig_s:      full-device reconfiguration time ``t_r`` (bitstream load
                     on FPGA; stage weight-swap estimate on TPU).
    """
    name: str
    compute_units: float
    onchip_bits: float
    offchip_gbps: float
    luts: float = 0.0
    freq_mhz: float = 200.0
    reconfig_s: float = 0.05
    bram18k: int = 0
    uram: int = 0

    @property
    def cycles_per_s(self) -> float:
        return self.freq_mhz * 1e6

    def words_per_cycle_offchip(self, word_bits: int) -> float:
        """Off-chip bandwidth expressed in stream words per cycle."""
        return (self.offchip_gbps * 1e9) / (word_bits * self.cycles_per_s)


def _fpga(name, dsp, bram18k, uram, luts, ddr_gbps, freq=200.0, reconfig=0.06):
    # compute budget in MACs/cycle: DSP48E2 packs 2 x 8-bit MACs (paper's
    # designs quantise weights/activations to 8 bit, §V-A).
    return Device(
        name=name, compute_units=dsp * 2,
        onchip_bits=bram18k * BRAM18K_BITS + uram * URAM_BITS,
        offchip_gbps=ddr_gbps, luts=luts, freq_mhz=freq, reconfig_s=reconfig,
        bram18k=bram18k, uram=uram,
    )


# -- paper devices (§V, Table V) ---------------------------------------------
# DDR bandwidths: ZCU102 1x DDR4-2400 (~154 Gbps); U200/VCU1525/VCU118 are
# VU9P-class boards with 4x DDR4-2400 banks (~614 Gbps total, matching
# Fig. 4's "225 Gbps (37%)" annotation for the U200 design).
ZCU102 = _fpga("zcu102", dsp=2520, bram18k=1824, uram=0, luts=274_000,
               ddr_gbps=154.0, freq=200.0)
U200 = _fpga("u200", dsp=6840, bram18k=4320, uram=960, luts=1_182_000,
             ddr_gbps=614.0, freq=250.0)
VCU1525 = _fpga("vcu1525", dsp=6840, bram18k=4320, uram=960, luts=1_182_000,
                ddr_gbps=614.0, freq=200.0)
VCU118 = _fpga("vcu118", dsp=6840, bram18k=4320, uram=960, luts=1_182_000,
               ddr_gbps=614.0, freq=240.0)

FPGA_DEVICES = {d.name: d for d in (ZCU102, U200, VCU1525, VCU118)}


ALL_DEVICES = dict(FPGA_DEVICES)


def get_device(name: str) -> Device:
    try:
        return ALL_DEVICES[name]
    except KeyError:
        raise KeyError(f"unknown device {name!r}; have {sorted(ALL_DEVICES)}") from None
