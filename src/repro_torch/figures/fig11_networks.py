"""Paper Fig. 11: neural-network demonstrations and the summary /
comparison tables.  Port of ``benchmarks/fig11_networks.py``; the 65 nm
chip model (:mod:`repro_torch.core.energy`), no device work.

Energy and throughput of Networks A and B against the paper's chip
measurements (A, 4b/4b ADC: 105.2 µJ/image, 23 fps; B, 1b/1b ABN: 5.31
µJ/image, 176 fps), and the headline efficiency and throughput (152 /
297 1b-TOPS/W, 4.7 / 1.9 1b-TOPS)."""
from __future__ import annotations

from repro_torch.core import energy as E

from .common import emit


def run(device=None):
    # headline: derived from the component table, must match measurements
    for vdd, tops_ref, eff_ref in ((1.2, 4.7, 152.0), (0.85, 1.9, 297.0)):
        tops = E.peak_tops_1b(vdd)
        eff = E.peak_tops_per_w_1b(vdd)
        assert abs(tops - tops_ref) / tops_ref < 0.02
        assert abs(eff - eff_ref) / eff_ref < 0.02
        emit(f"fig11_peak_vdd{vdd}", 0.0,
             f"tops={tops:.2f}(paper {tops_ref});"
             f"tops_per_w={eff:.1f}(paper {eff_ref})")

    # bit-scalability: 1b-TOPS scales linearly with B_A x B_X
    for ba, bx in ((1, 1), (2, 2), (4, 4), (8, 8)):
        t = E.peak_tops_1b(1.2) / (ba * bx)
        emit(f"fig11_tops_Ba{ba}_Bx{bx}", 0.0, f"effective_tops={t:.3f}")

    a = E.network_cost(E.NETWORK_A, 4, 4, vdd=0.85, sparsity=0.5,
                       readout="adc")
    emit("fig11_network_a", 0.0,
         f"energy_uJ={a['energy_uj']:.1f}(paper 105.2);"
         f"fps={a['fps']:.1f}(paper 23)")
    assert abs(a["energy_uj"] - 105.2) / 105.2 < 0.10
    assert abs(a["fps"] - 23) / 23 < 0.10

    b = E.network_cost(E.NETWORK_B, 1, 1, vdd=0.85, sparsity=0.0,
                       readout="abn", overhead_cycles=149500)
    emit("fig11_network_b", 0.0,
         f"energy_uJ={b['energy_uj']:.2f}(paper 5.31, +25% documented);"
         f"fps={b['fps']:.1f}(paper 176)")
    assert abs(b["fps"] - 176) / 176 < 0.05

    # comparison-table row for "this work": config dims + bits
    emit("fig11_comparison_this_work", 0.0,
         "tech=65nm;mem=74kB_imc;bits=1-8;dims_configurable=yes;"
         f"tops_1b={E.peak_tops_1b(1.2):.1f};"
         f"eff_1b={E.peak_tops_per_w_1b(1.2):.0f}")
