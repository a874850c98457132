"""Resource models: the paper's FPGA devices and the port's H100.

SMOF's constraints (Eq. 7) are expressed against a device budget of
compute units, on-chip memory bits, and off-chip bandwidth.  Two families
of instances:

* the four AMD FPGA devices used in the paper's evaluation (§V), with
  DSP / BRAM18K / URAM / LUT / DDR-bandwidth budgets (``ALL_DEVICES``):
  the sheets the CNN paths plan on;
* the NVIDIA H100 the port runs on, in two views, the counterparts of the
  reference package's accelerator pair:
    - ``H100_KERNEL``:  on-chip = shared memory, off-chip = HBM  (kernel
      level);
    - ``H100_RUNTIME``: on-chip = HBM, off-chip = host memory over the
      host link (staged-executor / offload level), the sheet
      ``core.lm_graph``'s layer graphs are planned on.

Where the tensors of a lowered plan live is a separate choice
(``CompileSpec.torch_device``).
"""
from __future__ import annotations

import dataclasses

BRAM18K_BITS = 18 * 1024
URAM_BITS = 288 * 1024


@dataclasses.dataclass(frozen=True)
class Device:
    """A SMOF-visible resource budget.

    compute_units:   MACs/cycle available (DSPs on FPGA; the f32 peak over
                     2 f on the H100).
    onchip_bits:     total "on-chip" storage in bits (BRAM+URAM / shared
                     memory / HBM).
    offchip_gbps:    usable "off-chip" bandwidth, Gbit/s (DDR / HBM / host
                     link).
    luts:            logic budget; codecs charge against it (FPGA only —
                     the H100 views set it to 0 and codec cost becomes
                     compute).
    freq_mhz:        pipeline clock.
    reconfig_s:      full-device reconfiguration time ``t_r`` (bitstream load
                     on FPGA; stage weight-swap estimate on the H100).
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


# -- NVIDIA H100 (the port's card) ---------------------------------------------
# Every constant is one card's, NVIDIA H100 80GB HBM3 at its 700.00 W power
# limit (nvidia-smi --query-gpu=name,power.limit): the data sheet's (SXM
# part, dense rates) where it says so, else read on that card by
# chip_smoke.py's phase 1, which prints each beside what the card reports
# and fails where a sheet claims more than the card has.
H100_SMS = 132                     # streaming multiprocessors (data sheet)
# programmer-managed shared memory a multiprocessor, the kernel view's
# on-chip store; the 50 MB L2 is a cache and is not counted (data sheet)
H100_SMEM_PER_SM_BYTES = 228 * 1024
H100_HBM_BYTES = 85_017_493_504   # total_memory of the card (torch)
H100_HBM_GBPS = 3.35e12 * 8 / 1e9  # HBM3, 3.35 TB/s (data sheet)
# the host link: a 256 MiB pinned copy timed with CUDA events read 387.49
# Gbit/s host -> device and 438.13 device -> host (chip_smoke.py phase 1);
# the slower direction, rounded down
H100_HOST_LINK_GBPS = 387.0
H100_PEAK_F32_FLOPS = 67e12        # f32 outside the tensor cores (data sheet)
H100_FREQ_MHZ = 1980.0             # nvidia-smi clocks.max.sm
# MACs/cycle at the f32 peak, peak / (2 f): the port computes in f32 with
# TF32 off on its parity path
_H100_MACS_PER_CYCLE = H100_PEAK_F32_FLOPS / (2 * H100_FREQ_MHZ * 1e6)

H100_KERNEL = Device(
    name="h100_kernel", compute_units=_H100_MACS_PER_CYCLE,
    onchip_bits=H100_SMS * H100_SMEM_PER_SM_BYTES * 8.0,
    offchip_gbps=H100_HBM_GBPS, luts=0.0, freq_mhz=H100_FREQ_MHZ,
    reconfig_s=0.0,
)
H100_RUNTIME = Device(
    name="h100_runtime", compute_units=_H100_MACS_PER_CYCLE,
    onchip_bits=H100_HBM_BYTES * 8.0, offchip_gbps=H100_HOST_LINK_GBPS,
    luts=0.0, freq_mhz=H100_FREQ_MHZ,
    # a stage's weight swap over the host link: the reference's 10 ms
    # budget for its own sheet, kept (a budget, not measured on the card)
    reconfig_s=0.010,
)

# the sheets a name selects (CompileSpec.device): the FPGA devices only;
# the H100 views are passed as Device instances
ALL_DEVICES = dict(FPGA_DEVICES)
# the non-FPGA sheets by name: a plan made on one records that name as its
# device, and an artifact loaded from it finds its sheet here
GPU_SHEETS = {d.name: d for d in (H100_KERNEL, H100_RUNTIME)}


def get_device(name: str) -> Device:
    try:
        return ALL_DEVICES[name]
    except KeyError:
        raise KeyError(f"unknown device {name!r}; have {sorted(ALL_DEVICES)}") from None


def find_sheet(name: str) -> Device | None:
    """The sheet a recorded device name stands for, FPGA or GPU, or
    ``None``."""
    return ALL_DEVICES.get(name) or GPU_SHEETS.get(name)
