"""The port's chip cost model against the JAX package's.

``repro_torch.core.energy`` is a copy of the pure-Python reference, so
every figure must equal it float for float.  ``core.sparsity`` counts are
exact.  ``sqnr_db`` takes two float32 means whose summation order differs
between XLA and torch, so SQNR is held at rtol 1e-6.  ``energy_summary``
is held float for float on record lists that both packages trace from
the same numpy inputs (the records themselves must be equal field for
field, measured sparsity and planes included).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import accel as jaccel
from repro.accel import program as jprogram
from repro.core import energy as JE
from repro.core import sparsity as jsp
from repro.core import sqnr as jsqnr
from repro.core.bpbs import BpbsConfig as JCfg
from repro_torch import accel as taccel
from repro_torch.accel import program as tprogram
from repro_torch.core import energy as TE
from repro_torch.core import sparsity as tsp
from repro_torch.core import sqnr as tsqnr
from repro_torch.core.bpbs import BpbsConfig as TCfg

SHAPES = [(27, 128), (1152, 128), (2304, 256), (4096, 1024), (16384, 1024),
          (1024, 10), (2048, 50304), (300, 40)]
PRECISIONS = [(1, 1), (4, 4), (2, 3), (8, 8)]
RECORD_FIELDS = ("tag", "backend", "n", "m", "ba", "bx", "calls", "program",
                 "loads", "load_segments", "stream_overlap", "load_prologue",
                 "devices", "partition", "data_shards", "post_ops",
                 "sparsity", "planes_skipped", "planes_total", "copies")
PORT_BACKEND = {"digital_int": "digital_int", "bpbs": "bpbs",
                "pallas": "kernel", "digital": "digital"}


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


# ------------------------------------------------------------ core/energy

def test_constants_equal_reference():
    for name in ("CIMA_ROWS", "CIMA_COLS", "ADC_BITS", "DMA_WORD",
                 "A_ROW_SEGMENT", "C_LOAD", "C_A", "F_CLK", "VDD_CORNERS",
                 "ENERGY_PJ", "CYCLES_PER_EVAL_ABN", "CYCLES_PER_EVAL_ADC",
                 "CIMA_SPARSITY_GATEABLE"):
        assert getattr(TE, name) == getattr(JE, name), name
    for tn, jn in ((TE.NETWORK_A, JE.NETWORK_A), (TE.NETWORK_B, JE.NETWORK_B)):
        assert [dataclasses.astuple(x) for x in tn] == \
            [dataclasses.astuple(x) for x in jn]


@pytest.mark.parametrize("vdd", [1.2, 0.85])
@pytest.mark.parametrize("readout", ["adc", "abn"])
def test_cost_functions_equal_reference(vdd, readout):
    for n, m in SHAPES:
        for ba, bx in PRECISIONS:
            ts, js = TE.MvmShape(n, m, ba, bx), JE.MvmShape(n, m, ba, bx)
            assert (ts.n_banks, ts.col_tiles, ts.evals, ts.macs) == \
                (js.n_banks, js.col_tiles, js.evals, js.macs)
            assert TE.output_bits(bx, ba, readout) == \
                JE.output_bits(bx, ba, readout)
            for sp, skip, reuse in ((0.0, 0.0, 1.0), (0.37, 0.25, 3.0)):
                assert TE.mvm_energy_pj(ts, vdd, sp, readout, reuse, skip) \
                    == JE.mvm_energy_pj(js, vdd, sp, readout, reuse, skip)
                assert TE.mvm_cycles(ts, readout, skip) == \
                    JE.mvm_cycles(js, readout, skip)
            assert TE.transfer_cycles(ts, readout) == \
                JE.transfer_cycles(js, readout)
            assert TE.utilization(ts, readout) == JE.utilization(js, readout)
    assert TE.validate_vdd(vdd) == JE.validate_vdd(vdd)
    assert TE.peak_tops_1b(vdd) == JE.peak_tops_1b(vdd)
    assert TE.peak_tops_per_w_1b(vdd) == JE.peak_tops_per_w_1b(vdd)
    for rows in (2304, 1000, 27):
        assert TE.matrix_load_cycles(rows) == JE.matrix_load_cycles(rows)
    for tl, jl in zip(TE.NETWORK_A + TE.NETWORK_B,
                      JE.NETWORK_A + JE.NETWORK_B):
        assert tl.pixels == jl.pixels
        assert dataclasses.astuple(tl.mvm(4, 4)) == \
            dataclasses.astuple(jl.mvm(4, 4))
    for net_t, net_j, ba in ((TE.NETWORK_A, JE.NETWORK_A, 4),
                             (TE.NETWORK_B, JE.NETWORK_B, 1)):
        for kw in ({}, {"sparsity": 0.0, "overhead_cycles": 149500.0,
                        "overhead_energy_pj": 12.5}):
            assert TE.network_cost(net_t, ba, ba, vdd=vdd, readout=readout,
                                   **kw) == \
                JE.network_cost(net_j, ba, ba, vdd=vdd, readout=readout, **kw)


def test_unmeasured_corner_raises_like_reference():
    for mod in (TE, JE):
        with pytest.raises(ValueError, match="supply corner"):
            mod.validate_vdd(1.0)
        with pytest.raises(ValueError, match="supply corner"):
            mod.network_cost(mod.NETWORK_A, 4, 4, vdd=1.1)
    with pytest.raises(ValueError, match="supply corner"):
        with taccel.trace(vdd=0.9):
            pass


def test_network_cost_reproduces_paper_headlines():
    """As tests/test_core_energy.py holds the reference: Fig. 11's
    105.2 / 5.31 uJ and 23 / 176 fps, and the 152 / 297 1b-TOPS/W."""
    a = TE.network_cost(TE.NETWORK_A, 4, 4, vdd=0.85, sparsity=0.5)
    assert abs(a["energy_uj"] - 105.2) / 105.2 < 0.10
    assert abs(a["fps"] - 23.0) / 23.0 < 0.10
    b = TE.network_cost(TE.NETWORK_B, 1, 1, vdd=0.85, sparsity=0.0,
                        readout="abn", overhead_cycles=149500)
    assert abs(b["fps"] - 176.0) / 176.0 < 0.05
    assert abs(b["energy_uj"] - 5.31) / 5.31 < 0.35   # the reference's gap
    assert abs(TE.peak_tops_per_w_1b(1.2) - 152) / 152 < 0.02
    assert abs(TE.peak_tops_per_w_1b(0.85) - 297) / 297 < 0.02
    assert TE.matrix_load_cycles() == 768 * 24


# ---------------------------------------------------------- core/sparsity

@pytest.mark.parametrize("coding", ["xnor", "and"])
@pytest.mark.parametrize("bx,bank_n", [(1, 64), (4, 128), (3, 100)])
def test_sparsity_functions_equal_reference(coding, bx, bank_n):
    r = np.random.default_rng(bx * 7 + bank_n)
    x = r.integers(-3, 4, (5, 300)).astype(np.float32)
    x[:, 64:192] = 0.0                            # whole banks of zeros
    x[1, :10] = 0.0
    if coding == "xnor":
        x = 2 * np.round(x / 2)
    jm = jsp.element_mask(jnp.asarray(x))
    tm = tsp.element_mask(torch.from_numpy(x))
    for axis in (-1, 0):
        np.testing.assert_array_equal(
            tsp.unmasked_count(tm, axis).numpy(),
            np.asarray(jsp.unmasked_count(jm, axis)))
        np.testing.assert_array_equal(
            tsp.masked_tally(tm, axis).numpy(),
            np.asarray(jsp.masked_tally(jm, axis)))
    assert float(tsp.sparsity_fraction(tm)) == \
        float(jsp.sparsity_fraction(jm))
    jc = JCfg(ba=2, bx=bx, coding=coding, bank_n=bank_n)
    tc = TCfg(ba=2, bx=bx, coding=coding, bank_n=bank_n)
    for xi in (x, x[0], x.reshape(5, 2, 150)[:, 0]):
        assert tsp.count_zero_planes(torch.from_numpy(np.ascontiguousarray(
            xi)), tc) == jsp.count_zero_planes(jnp.asarray(xi), jc)


# -------------------------------------------------------------- core/sqnr

def test_sqnr_db_equals_reference():
    r = np.random.default_rng(0)
    y = r.normal(size=(64, 64)).astype(np.float32) * 50
    y_hat = y + r.normal(size=y.shape).astype(np.float32)
    a = float(tsqnr.sqnr_db(torch.from_numpy(y), torch.from_numpy(y_hat)))
    b = float(jsqnr.sqnr_db(jnp.asarray(y), jnp.asarray(y_hat)))
    assert a == pytest.approx(b, rel=1e-6)
    assert float(tsqnr.sqnr_db(torch.from_numpy(y), torch.from_numpy(y))) \
        == pytest.approx(float(jsqnr.sqnr_db(jnp.asarray(y),
                                             jnp.asarray(y))), rel=1e-6)


@pytest.mark.parametrize("coding,n,ba,bx", [("xnor", 300, 4, 4),
                                            ("xnor", 2304, 1, 1),
                                            ("and", 600, 3, 2)])
def test_measure_sqnr_equals_reference_on_same_operands(coding, n, ba, bx):
    """Operands drawn by the reference (jax.random) go through both
    packages' ``measure_sqnr`` pipeline (BP/BS + ADC against x @ w)."""
    import jax

    x, w = jsqnr.random_operands(jax.random.PRNGKey(n), 16, n, 24, ba, bx,
                                 coding, sparsity=0.2)
    xn, wn = np.array(x), np.array(w)
    cfg = JCfg(ba=ba, bx=bx, coding=coding)
    from repro.core.bpbs import bpbs_matmul_int

    want = float(jsqnr.sqnr_db(x @ w, bpbs_matmul_int(x, w, cfg)))
    got = tsqnr.measure_sqnr(None, n, ba, bx, coding, operands=(
        torch.from_numpy(xn), torch.from_numpy(wn)))
    assert got == pytest.approx(want, rel=1e-6)


def test_random_operands_keep_the_reference_grids():
    g = torch.Generator().manual_seed(0)
    for coding, ba, bx in (("xnor", 1, 1), ("xnor", 4, 3), ("and", 2, 5)):
        x, w = tsqnr.random_operands(g, 8, 100, 12, ba, bx, coding,
                                     sparsity=0.5 if bx > 1 else 0.0)
        for v, bits in ((x, bx), (w, ba)):
            lo, hi = {"xnor": (-(2 ** (bits - 1)), 2 ** (bits - 1)),
                      "and": (-(2 ** (bits - 1)), 2 ** (bits - 1) - 1)}[
                coding] if bits > 1 else {"xnor": (-1, 1),
                                          "and": (0, 1)}[coding]
            assert float(v.min()) >= lo and float(v.max()) <= hi
            if coding == "xnor" and bits > 1:
                assert bool(torch.all(v % 2 == 0))
        if coding == "xnor" and bx == 1:
            assert bool(torch.all(x != 0)) and bool(torch.all(w != 0))


def test_sweep_fig7_subset_matches_reference_grid():
    """Four Fig. 7 points: the same grid in the same order, and SQNR
    within 1 dB of the reference's (the two draw different operands)."""
    import jax

    kw = dict(n_values=(255, 2304), ba_values=(1, 4), bx_values=(2,),
              codings=("xnor",))
    jp = jsqnr.sweep_fig7(jax.random.PRNGKey(0), **kw)
    tp = tsqnr.sweep_fig7(torch.Generator().manual_seed(0), **kw)
    assert [(p.coding, p.n, p.ba, p.bx, p.sparsity) for p in tp] == \
        [(p.coding, p.n, p.ba, p.bx, p.sparsity) for p in jp]
    for a, b in zip(tp, jp):
        assert abs(a.sqnr_db - b.sqnr_db) < 1.0, (a, b)
    # N = 255 fits the 8-b ADC: bit-true; N = 2304 does not
    assert tp[0].sqnr_db > 200 and tp[2].sqnr_db < 60


def test_sweep_fig7_draws_on_the_device_it_is_given():
    """Without a generator the sweep seeds one on ``device`` (the card
    unless the caller asks for the CPU): on the CPU that is the sweep of
    an explicit CPU generator seeded with 0."""
    kw = dict(n_values=(255,), ba_values=(2, 4), bx_values=(2,),
              codings=("and",))
    by_device = tsqnr.sweep_fig7(device="cpu", **kw)
    by_gen = tsqnr.sweep_fig7(torch.Generator().manual_seed(0), **kw)
    assert by_device == by_gen
    x, _ = tsqnr.random_operands(torch.Generator().manual_seed(0), 2, 8, 3,
                                 2, 2, "and", sparsity=0.5)
    assert x.device.type == "cpu"


# ------------------------------------------------- trace + energy_summary

def _same_records(tr, jr):
    assert len(tr) == len(jr)
    for t, j in zip(tr, jr):
        got = {f: getattr(t, f) for f in RECORD_FIELDS}
        want = {f: getattr(j, f) for f in RECORD_FIELDS}
        got["backend"] = [k for k, v in PORT_BACKEND.items()
                          if v == got["backend"]][0]
        assert got == want


def _same_summary(ts, js):
    """Equal summaries, the reference's backend names mapped onto the
    port's (an untagged record is keyed by its backend)."""
    js = dict(js)
    js["by_tag"] = {PORT_BACKEND.get(k, k): dict(row, backend=PORT_BACKEND[
        row["backend"]]) for k, row in js["by_tag"].items()}
    assert ts == js


def _pair(n, m, path, *, seed=0, backend="digital_int", ba=4, bx=4,
          resident=True, overlap=False, **spec_kw):
    """The same operands and streamed-or-resident image in both packages."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(4, n)).astype(np.float32)
    w = r.normal(size=(n, m)).astype(np.float32)
    js = jaccel.ExecSpec(backend=backend, ba=ba, bx=bx, **spec_kw)
    ts = taccel.ExecSpec(backend=PORT_BACKEND[backend], ba=ba, bx=bx,
                         **spec_kw)
    ji = dataclasses.replace(jprogram._compile_image(jnp.asarray(w), js, path),
                             resident=resident, overlap=overlap)
    ti = dataclasses.replace(tprogram._compile_image(torch.from_numpy(w), ts,
                                                     path),
                             resident=resident, overlap=overlap)
    return (jnp.asarray(x), jnp.asarray(w), js, ji), \
        (torch.from_numpy(x), torch.from_numpy(w), ts, ti)


def _both(pairs, vdd=None, **es_kw):
    with jaccel.trace(vdd=vdd) as jr:
        for (x, w, s, i), _ in pairs:
            jaccel.matmul(x, w, s, image=i)
    with taccel.trace(vdd=vdd) as tr:
        for _, (x, w, s, i) in pairs:
            taccel.matmul(x, w, s, image=i)
    _same_records(tr, jr)
    ts, js = taccel.energy_summary(tr, **es_kw), jaccel.energy_summary(jr,
                                                                       **es_kw)
    _same_summary(ts, js)
    return tr, ts


@pytest.mark.parametrize("vdd", [None, 1.2])
def test_overlap_wall_cycles_equal_reference(vdd):
    """test_stream_overlap.py::test_overlap_wall_cycles_are_max_not_sum on
    both packages: synchronous and double-buffered streams, resident
    compute; the port's summary equals the reference's."""
    shapes = [(2304, 64), (1200, 32), (600, 48)]
    comp = []
    for i, (n, m) in enumerate(shapes):
        _, es = _both([_pair(n, m, f"p{i}", seed=i)], vdd=vdd)
        assert es["load_cycles"] == 0
        comp.append(es["total_cycles"])
    _, es_s = _both([_pair(n, m, f"p{i}", seed=i, resident=False)
                     for i, (n, m) in enumerate(shapes)], vdd=vdd)
    recs_o, es_o = _both([_pair(n, m, f"p{i}", seed=i, resident=False,
                                overlap=True)
                          for i, (n, m) in enumerate(shapes)], vdd=vdd)
    lc = [r.loads * r.load_segments * tprogram.segment_cycles()
          for r in recs_o]
    assert lc[0] == 18432
    assert es_s["total_cycles"] == sum(comp) + sum(lc)
    hidden = sum(min(c, v) for c, v in zip(comp[1:], lc[1:]))
    assert es_o["total_cycles"] == comp[0] + lc[0] + sum(
        max(c, v) for c, v in zip(comp[1:], lc[1:]))
    assert es_o["load_cycles_hidden"] == hidden > 0
    assert es_o["load_pj"] == es_s["load_pj"] > 0


def test_prologue_charged_once_per_pass_like_reference():
    pairs = [_pair(600, 32, f"q{i}", seed=i, resident=False, overlap=True)
             for i in range(3)]
    for _ in range(2):                       # a fresh trace re-arms it
        recs, _ = _both(pairs)
        assert [r.load_prologue for r in recs] == [1, 0, 0]
    recs, _ = _both([_pair(600, 32, "q0", resident=False)])
    assert recs[0].load_prologue == 0 and not recs[0].stream_overlap


@pytest.mark.parametrize("readout", ["adc", "abn"])
def test_trace_resolved_specs_and_energy_equal_reference(readout):
    """test_accel.py::test_trace_records_resolved_specs_and_energy."""
    r = np.random.default_rng(0)
    x = r.normal(size=(4, 512)).astype(np.float32)
    w = r.normal(size=(512, 32)).astype(np.float32)

    def run(acc, backend, xa, wa):
        pol = acc.PrecisionPolicy(
            rules=(("path:mlp.down", acc.ExecSpec(backend=backend, ba=1,
                                                  bx=1)),),
            default=acc.ExecSpec(backend=backend, ba=4, bx=4))
        with acc.trace() as recs:
            acc.matmul(xa, wa, pol.resolve("mlp.down", kind="mlp"))
            acc.matmul(xa, wa, pol.resolve("mlp.up", kind="mlp"))
            acc.matmul(xa, wa, None)
        return recs

    jr = run(jaccel, "bpbs", jnp.asarray(x), jnp.asarray(w))
    tr = run(taccel, "bpbs", torch.from_numpy(x), torch.from_numpy(w))
    _same_records(tr, jr)
    assert [(t.tag, t.ba) for t in tr] == [("mlp.down", 1), ("mlp.up", 4)]
    for vdd in (0.85, 1.2):
        ts = taccel.energy_summary(tr, vdd=vdd, readout=readout)
        _same_summary(ts, jaccel.energy_summary(jr, vdd=vdd,
                                                readout=readout))
        assert ts["by_tag"]["mlp.down"]["pj"] < ts["by_tag"]["mlp.up"]["pj"]


@pytest.mark.parametrize("backend", ["bpbs", "pallas"])
def test_plane_skip_records_and_discount_equal_reference(backend):
    """test_sparsity_noise.py::test_trace_records_planes_skipped_and_
    discounts_cost: block-sparse inputs, measured on both packages."""
    r = np.random.default_rng(0)
    n, bank_n, bx = 256, 32, 4
    w = r.normal(size=(n, 16)).astype(np.float32)
    recs, sums = [], []
    for sparsity in (0.0, 0.5):
        x = r.normal(size=(4, n)).astype(np.float32)
        x[:, :int(round(sparsity * n))] = 0.0
        js = jaccel.ExecSpec(backend=backend, ba=4, bx=bx, bank_n=bank_n)
        ts = taccel.ExecSpec(backend=PORT_BACKEND[backend], ba=4, bx=bx,
                             bank_n=bank_n)
        with jaccel.trace() as jr:
            jaccel.matmul(jnp.asarray(x), jnp.asarray(w), js)
        with taccel.trace() as tr:
            taccel.matmul(torch.from_numpy(x), torch.from_numpy(w), ts)
        _same_records(tr, jr)
        es = taccel.energy_summary(tr, sparsity=0.3)
        _same_summary(es, jaccel.energy_summary(jr, sparsity=0.3))
        recs.append(tr[0])
        sums.append(es)
    assert recs[0].planes_skipped == 0
    assert recs[1].planes_skipped == (n // bank_n) // 2 * bx
    assert recs[1].planes_total == (n // bank_n) * bx
    assert sums[1]["plane_skip"] == pytest.approx(0.5)
    assert sums[1]["total_cycles"] < sums[0]["total_cycles"]
    assert sums[1]["total_pj"] < sums[0]["total_pj"]


def test_pad_positions_strip_and_vmapped_scale_like_reference():
    """Measured sparsity excludes positions a pad_positions scope marks,
    and a vmapped(n) scope scales calls, loads and copies."""
    r = np.random.default_rng(3)
    x = r.normal(size=(2, 6, 64)).astype(np.float32)
    x[0, :3] = 0.0                                 # left padding of row 0
    mask = np.ones((2, 6), bool)
    mask[0, :3] = False
    (jx, jw, js, ji), (tx, tw, ts, ti) = _pair(64, 8, "v", resident=False,
                                                overlap=True)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    with jaccel.trace() as jr:
        with jaccel.pad_positions(jnp.asarray(mask)), jaccel.vmapped(3):
            jaccel.matmul(jx, jw, js, image=ji)
    with taccel.trace() as tr:
        with taccel.pad_positions(torch.from_numpy(mask)), \
                taccel.vmapped(3):
            taccel.matmul(tx, tw, ts, image=ti)
    _same_records(tr, jr)
    assert tr[0].calls == 36 and tr[0].loads == 3 and tr[0].copies == 3
    assert tr[0].load_prologue == 1
    _same_summary(taccel.energy_summary(tr), jaccel.energy_summary(jr))


def test_trace_vdd_resolution_like_reference():
    pairs = [_pair(300, 24, "a", backend="bpbs")]
    for vdd in (None, 0.85, 1.2):
        with taccel.trace(vdd=vdd) as tr:
            for _, (x, w, s, i) in pairs:
                taccel.matmul(x, w, s, image=i)
        assert tr.vdd == vdd
        es = taccel.energy_summary(tr)
        assert es["vdd"] == (0.85 if vdd is None else vdd)
        assert taccel.energy_summary(tr, vdd=1.2)["vdd"] == 1.2
    _both(pairs, vdd=1.2)


def test_untraced_dispatch_measures_nothing(monkeypatch):
    """Outside a trace() scope dispatch neither records nor measures: the
    serving path pays no device-to-host read for the cost model."""
    from repro_torch.accel import dispatch

    def measured(*args):
        raise AssertionError("measured a dispatch")

    monkeypatch.setattr(dispatch, "_measured_sparsity", measured)
    monkeypatch.setattr(dispatch, "_measured_planes", measured)
    _, (x, w, spec, img) = _pair(300, 24, "u", backend="pallas",
                                 resident=False, overlap=True)
    taccel.matmul(x, w, spec, image=img)
    with pytest.raises(AssertionError, match="measured a dispatch"):
        with taccel.trace():
            taccel.matmul(x, w, spec, image=img)
