"""Paper Fig. 8: data-bandwidth and utilization analysis of the CIMU
behind the 32-b DMA, plus the matrix-load cost (C_LOAD vs C_A).  Port of
``benchmarks/fig8_bandwidth.py``; the 65 nm chip model, no device work
(``device`` is accepted for a uniform ``run``)."""
from __future__ import annotations

from repro_torch.core import energy as E

from .common import emit


def run(device=None):
    # C_x / C_y / C_CIMU at max dimensionalities N=2304, M=256/B_A
    for ba in (1, 2, 4, 8):
        for bx in (1, 2, 4, 8):
            m = 256 // ba
            shape = E.MvmShape(2304, m, ba, bx)
            c_x, c_y = E.transfer_cycles(shape)
            c_cimu = E.mvm_cycles(shape)
            util = E.utilization(shape)
            emit(f"fig8_cycles_Ba{ba}_Bx{bx}", 0.0,
                 f"Cx={c_x};Cy={c_y};Ccimu={c_cimu};util={util:.2f};"
                 f"By={E.output_bits(bx, ba)}")
    # pipelined utilization is high at multi-bit precisions (paper text)
    assert E.utilization(E.MvmShape(2304, 64, 4, 4)) > 0.85
    # matrix loading: 768 segments x max(C_A=24, C_LOAD=20) ~ 18k cycles
    cycles = E.matrix_load_cycles()
    assert cycles == 18432
    emit("fig8_matrix_load", 0.0, f"cycles={cycles};paper=~18k")
