"""Energy / cycle / bandwidth cost model of the chip (paper Figs. 8, 11).
Port of ``repro.core.energy``: pure Python, copied verbatim below this
header, so every figure equals the reference's float for float.

All constants come from the paper's measured Summary table (65nm, 590kb
CIMA = 2304 rows x 256 columns, F_CLK 100/40 MHz at VDD 1.2/0.85 V; the
P/DMEM and Reshaping-Buffer low-voltage numbers were measured at 0.7 V).

Calibration notes:

* ``CYCLES_PER_EVAL_ABN = 25`` is derived from the measured peak
  throughput: 2*2304*256 1b-ops/eval * 100 MHz / 4.7 TOPS = 25.1 cycles
  (and 40 MHz / 1.9 TOPS = 24.8 — consistent across both corners).
* The headline energy efficiencies follow *exactly* from the component
  table under the ABN (BNN) readout path:
  2*2304 / (20.4 + 9.78) pJ = 152.7 1b-TOPS/W  (paper: 152)
  2*2304 / (10.7 + 4.92) pJ = 295.0 1b-TOPS/W  (paper: 297).
* ``CYCLES_PER_EVAL_ADC = 65`` models the ADC+datapath path: the 8-b SAR
  conversion through the 8:1-multiplexed datapath bounds the pipeline
  stage at ~8 columns x 8 bit-cycles = 64 cycles (+1 eval) per x-step,
  which is also what the measured Network-A throughput implies (23 fps at
  40 MHz over the Fig. 11 topology).
* Measured Network-B throughput (176 fps) implies ~150k cycles/image of
  non-CIMU work (DMA orchestration, pooling, BN bookkeeping on the
  RISC-V core); ``network_cost`` exposes it as ``overhead_cycles``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

CIMA_ROWS = 2304      # max input-vector dimensionality N (3*3*256)
CIMA_COLS = 256       # physical columns (M * B_A <= 256 per tile)
ADC_BITS = 8
DMA_WORD = 32         # bits per DMA transfer (~1 cycle each)
A_ROW_SEGMENT = 768   # bits per CIMA write row segment
C_LOAD = 20           # cycles to write one 768-b row segment
C_A = 24              # DMA cycles to deliver one 768-b row segment

F_CLK = {1.2: 100e6, 0.85: 40e6}

#: The chip's two measured supply corners (Summary table).  Every cost
#: function validates against this set: the old behaviour of mapping any
#: ``vdd`` to a table via ``<= 0.85`` silently priced e.g. 1.0 V runs at
#: the 1.2 V corner's clock.
VDD_CORNERS = tuple(sorted(F_CLK))


def validate_vdd(vdd: float) -> float:
    """The corner itself, or a clear error for anything unmeasured.

    The paper characterizes exactly two supply corners; there is no
    interpolation model between them, so accepting other values would
    silently price a fictional chip.
    """
    if vdd not in F_CLK:
        raise ValueError(
            f"vdd={vdd!r} is not a measured supply corner; the chip is "
            f"characterized at {VDD_CORNERS} V only")
    return vdd

# pJ per unit (Summary table).  Keys: VDD corner.
ENERGY_PJ = {
    1.2: dict(cpu_instr=52.0, pdmem_32b=96.0, dma_32b=13.5, reshape_32b=35.0,
              cima_col=20.4, adc_col=3.56, abn_col=9.78, datapath_out=14.7),
    0.85: dict(cpu_instr=26.0, pdmem_32b=33.0, dma_32b=7.0, reshape_32b=12.0,
               cima_col=10.7, adc_col=1.79, abn_col=4.92, datapath_out=8.3),
}

CYCLES_PER_EVAL_ABN = 25   # calibrated from measured peak TOPS (see above)
CYCLES_PER_EVAL_ADC = 65   # 8:1 mux x 8-b SAR + eval (see above)

# Fraction of CIMA column energy spent on x broadcast + local compute — the
# part the Sparsity Controller gates off (paper: "~50% of CIMA energy").
CIMA_SPARSITY_GATEABLE = 0.5


def output_bits(bx: int, ba: int, readout: str = "adc") -> int:
    """B_y chosen by the near-memory datapath (Fig. 8); 1 b for the ABN path."""
    if readout == "abn":
        return 1
    return 16 if (bx + ba) <= 5 else 32


@dataclasses.dataclass(frozen=True)
class MvmShape:
    """One logical MVM mapped onto the CIMA."""

    n: int            # input dimensionality
    m: int            # output dimensionality
    ba: int = 1
    bx: int = 1

    @property
    def n_banks(self) -> int:
        return -(-self.n // CIMA_ROWS)

    @property
    def col_tiles(self) -> int:
        return -(-(self.m * self.ba) // CIMA_COLS)

    @property
    def evals(self) -> int:
        """Full-array CIMA evaluations to produce all outputs (per x-step
        set: each eval already covers all B_X serial steps in the cycle
        model; energy counts per-column conversions explicitly)."""
        return self.n_banks * self.col_tiles

    @property
    def macs(self) -> int:
        return self.n * self.m


def mvm_energy_pj(
    shape: MvmShape,
    vdd: float = 1.2,
    sparsity: float = 0.0,
    readout: str = "adc",
    input_reuse: float = 1.0,
    plane_skip: float = 0.0,
) -> dict:
    """Energy breakdown (pJ) of one MVM through the CIMU.

    ``input_reuse`` models the Reshaping Buffer's CNN striding reuse: only
    ``1/input_reuse`` of input words are newly loaded (paper Fig. 6a).

    ``plane_skip`` is the fraction of (bank, input-plane) serial steps the
    Sparsity Controller skipped outright (all-zero planes, Fig. 6b): a
    skipped step fires no conversions at all, so every per-conversion
    term (charge share, readout, datapath) scales by ``1 - plane_skip``.
    Element-level ``sparsity`` still gates the broadcast share of the
    *surviving* conversions — the two discounts compose.  Input DMA/
    reshape words are NOT discounted: the controller derives the mask
    after the words arrive.
    """
    e = ENERGY_PJ[validate_vdd(vdd)]
    rows_frac = min(shape.n, CIMA_ROWS * shape.n_banks) / (CIMA_ROWS * shape.n_banks)
    # per-column-conversion counts: every (bank, bit-column, bit-step)
    conversions = shape.n_banks * shape.m * shape.ba * shape.bx \
        * (1.0 - plane_skip)
    cima = conversions * e["cima_col"] * rows_frac * (
        1.0 - CIMA_SPARSITY_GATEABLE * sparsity
    )
    if readout == "abn":
        read = conversions * e["abn_col"]
        datapath = 0.0
    else:
        read = conversions * e["adc_col"]
        datapath = conversions * e["datapath_out"]
    x_words = math.ceil(shape.n * shape.bx / DMA_WORD) / input_reuse
    y_words = math.ceil(shape.m * output_bits(shape.bx, shape.ba, readout) / DMA_WORD)
    reshape = x_words * e["reshape_32b"]
    dma = (x_words + y_words) * e["dma_32b"]
    total = cima + read + datapath + reshape + dma
    return dict(cima=cima, readout=read, datapath=datapath,
                reshape=reshape, dma=dma, total=total)


def mvm_cycles(shape: MvmShape, readout: str = "adc",
               plane_skip: float = 0.0) -> int:
    """CIMU compute cycles C_CIMU for one MVM.

    BS cost is linear in B_X (the ``* shape.bx`` factor), so a skipped
    all-zero (bank, plane) serial step is directly saved cycles —
    ``plane_skip`` (fraction of steps skipped) discounts the total.
    """
    per_eval = CYCLES_PER_EVAL_ABN if readout == "abn" else CYCLES_PER_EVAL_ADC
    return int(round(shape.evals * per_eval * shape.bx
                     * (1.0 - plane_skip)))


def transfer_cycles(shape: MvmShape, readout: str = "adc") -> tuple[int, int]:
    """(C_x, C_y): 32-b DMA cycles for the input and output vectors (Fig. 8)."""
    c_x = math.ceil(shape.n * shape.bx / DMA_WORD)
    c_y = math.ceil(shape.m * output_bits(shape.bx, shape.ba, readout) / DMA_WORD)
    return c_x, c_y


def utilization(shape: MvmShape, readout: str = "adc") -> float:
    """CIMU utilization with pipelined transfers (Fig. 8 discussion)."""
    c_x, c_y = transfer_cycles(shape)
    c_cimu = mvm_cycles(shape, readout)
    return c_cimu / max(c_cimu, c_x, c_y)


def matrix_load_cycles(rows: int = CIMA_ROWS) -> int:
    """Cycles to (re)load A: DMA-bound at C_A=24 > C_LOAD=20 per 768-b
    segment; 768 segments for the full array (paper: ~18k cycles)."""
    segments = math.ceil(rows * CIMA_COLS / A_ROW_SEGMENT)
    return segments * max(C_A, C_LOAD)


def peak_tops_1b(vdd: float = 1.2) -> float:
    """Peak 1-b TOPS (ABN/BNN path) — reproduces the 4.7/1.9 headline."""
    ops = 2.0 * CIMA_ROWS * CIMA_COLS
    return ops * F_CLK[validate_vdd(vdd)] / CYCLES_PER_EVAL_ABN / 1e12


def peak_tops_per_w_1b(vdd: float = 1.2) -> float:
    """Peak 1-b TOPS/W (ABN path) — reproduces the 152/297 headline."""
    e = ENERGY_PJ[validate_vdd(vdd)]
    ops_per_col = 2.0 * CIMA_ROWS
    return ops_per_col / (e["cima_col"] + e["abn_col"])  # (pJ) -> TOPS/W


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    """One layer of the paper's CIFAR networks (Fig. 11 topologies)."""

    cin: int
    cout: int
    k: int = 3            # k=0 marks a fully-connected layer
    out_hw: int = 32      # output spatial size (1 for FC)
    pool: bool = False

    def mvm(self, ba: int, bx: int) -> MvmShape:
        n = self.cin * (self.k * self.k if self.k else 1)
        return MvmShape(n=n, m=self.cout, ba=ba, bx=bx)

    @property
    def pixels(self) -> int:
        return self.out_hw * self.out_hw


def network_cost(
    layers: Sequence[ConvLayer],
    ba: int,
    bx: int,
    vdd: float = 0.85,
    sparsity: float = 0.5,
    readout: str = "adc",
    overhead_cycles: float = 0.0,
    overhead_energy_pj: float = 0.0,
) -> dict:
    """Per-image energy (uJ) and throughput (fps) for a CIFAR topology.

    ``overhead_*`` calibrate the non-CIMU work per image (pooling, BN
    bookkeeping, DMA orchestration on the RISC-V core) — see EXPERIMENTS.md.
    """
    validate_vdd(vdd)
    total_pj = overhead_energy_pj
    total_cycles = overhead_cycles
    for layer in layers:
        shape = layer.mvm(ba, bx)
        reuse = 3.0 if layer.k == 3 else 1.0   # striding reuse (Fig. 6a)
        e = mvm_energy_pj(shape, vdd, sparsity, readout, input_reuse=reuse)
        total_pj += e["total"] * layer.pixels
        total_cycles += mvm_cycles(shape, readout) * layer.pixels
    f = F_CLK[vdd]
    return dict(
        energy_uj=total_pj / 1e6,
        cycles=total_cycles,
        fps=f / total_cycles if total_cycles else float("inf"),
    )


# The paper's CIFAR-10 topologies (Fig. 11).
NETWORK_A = [  # 4b/4b
    ConvLayer(3, 128, 3, 32), ConvLayer(128, 128, 3, 32, pool=True),
    ConvLayer(128, 256, 3, 16), ConvLayer(256, 256, 3, 16, pool=True),
    ConvLayer(256, 256, 3, 8), ConvLayer(256, 256, 3, 8, pool=True),
    ConvLayer(256 * 16, 1024, 0, 1), ConvLayer(1024, 1024, 0, 1),
    ConvLayer(1024, 10, 0, 1),
]
NETWORK_B = [  # 1b/1b
    ConvLayer(3, 128, 3, 32), ConvLayer(128, 128, 3, 32, pool=True),
    ConvLayer(128, 256, 3, 16), ConvLayer(256, 256, 3, 16),
    ConvLayer(256, 256, 3, 16), ConvLayer(256, 256, 3, 16, pool=True),
    ConvLayer(256 * 64, 1024, 0, 1), ConvLayer(1024, 1024, 0, 1),
    ConvLayer(1024, 10, 0, 1),
]
