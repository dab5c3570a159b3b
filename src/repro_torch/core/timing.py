"""DRAM/HBM timing parameters and the scheduling-time model (paper §IV, Eq. 1).

The part of ``repro.core.timing`` that the controller's data plane
carries: the ``DRAMTimings`` dataclass (``MemoryController.timings``),
its ``DDR4_2400`` / ``HBM_V5E`` presets, and Eq. 1 with its
double-buffer extension. The cycle-level simulator stays in the
reference package until the simulator slice of the port.

All times are in FPGA/accelerator clock cycles unless noted.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.config import scheduler_sort_stages


@dataclasses.dataclass(frozen=True)
class DRAMTimings:
    """DDR4-2400-class timing parameters (in DRAM clock cycles)."""

    t_cl: int = 17    # CAS latency
    t_rcd: int = 17   # row address to column address delay
    t_rp: int = 17    # row precharge
    # Clock periods (ns): DDR4-2400 command clock 1200 MHz; FPGA fabric
    # 300 MHz (typical U250 memory-controller clock domain).
    t_mem_ns: float = 0.833
    t_fpga_ns: float = 3.333
    num_banks: int = 16
    row_bytes: int = 8192           # row buffer (page) size
    burst_bytes: int = 64           # one BL8 x 64b burst
    t_burst: int = 4                # cycles to stream one burst after CAS
    # Bus-turnaround penalties (DDR4 tWTR/tRTW class): cycles lost when the
    # data bus flips direction between a write and a read burst.
    t_wtr: int = 8                  # write -> read turnaround
    t_rtw: int = 4                  # read -> write turnaround

    # --- paper's derived averages (§IV, 'DRAM Timing Model') -------------
    @property
    def clock_ratio(self) -> float:
        return self.t_mem_ns / self.t_fpga_ns

    def t_mem_seq(self) -> float:
        """Average sequential-access latency in FPGA cycles (row-buffer hit)."""
        return self.t_cl * self.clock_ratio

    def t_mem_rand(self) -> float:
        """Average random-access latency in FPGA cycles (row conflict)."""
        return (self.t_rp + self.t_cl + self.t_rcd) * self.clock_ratio

    def row_of(self, addr):
        return addr // self.row_bytes

    def bank_of(self, addr):
        # Bank interleave on row index (closed-form, matches common DDR4
        # address mappings at this granularity).
        return (addr // self.row_bytes) % self.num_banks


DDR4_2400 = DRAMTimings()

# The reference's TPU v5e HBM preset, carried as data: much wider rows and
# higher relative conflict penalty against a 940 MHz core clock, with the
# smaller HBM bus-turnaround gaps.
HBM_V5E = DRAMTimings(
    t_cl=14, t_rcd=14, t_rp=14,
    t_mem_ns=0.55, t_fpga_ns=1.064,
    num_banks=32, row_bytes=16384, burst_bytes=512, t_burst=1,
    t_wtr=4, t_rtw=2,
)


def t_schedule(batch_size: int, data_cond_cycles: int = 2) -> float:
    """Eq. 1 — scheduling time for a batch of N requests (FPGA cycles).

    N cycles of batch formation (one request accepted per cycle) plus the
    bitonic network's log2(N)(log2(N)+1)/2 compare-exchange stages plus
    serial<->parallel data conditioning.
    """
    if batch_size <= 0:
        return 0.0
    return batch_size + scheduler_sort_stages(batch_size) + data_cond_cycles


def t_overlapped_schedule(
    batch_size: int,
    n_batches: int,
    service_cycles: float,
    data_cond_cycles: int = 2,
) -> float:
    """Eq. 1 extended with the DMA engine's double-buffer overlap.

    Only the first batch's scheduling latency is fully exposed: while a
    batch streams from DRAM the next one forms and sorts in the second
    input buffer, so each subsequent batch exposes only the residual
    ``max(0, t_schedule - service/n_batches)``.
    """
    if n_batches <= 0:
        return 0.0
    t_sch = t_schedule(batch_size, data_cond_cycles)
    resid = max(0.0, t_sch - service_cycles / n_batches) * (n_batches - 1)
    return t_sch + resid
