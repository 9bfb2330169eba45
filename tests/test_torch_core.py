"""The port's core numerics against the JAX package, bitwise.

The same inputs, made from a seeded numpy generator, go through
``repro.core`` and ``repro_torch.core``.  Quantized grids, planes, ADC
codes and BP/BS outputs are exact small integers or exact IEEE results of
the same operation sequence, so they must match bit for bit; only the
transcendental activations (silu, tanh-gelu) may differ by float32
rounding of ``exp``/``tanh`` (rtol 1e-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as jadc
from repro.core import bpbs as jbpbs
from repro.core import datapath as jdp
from repro.core import quant as jq
from repro_torch.core import adc as tadc
from repro_torch.core import bpbs as tbpbs
from repro_torch.core import datapath as tdp
from repro_torch.core import quant as tq

CODINGS = ("xnor", "and")


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _same(j, t):
    """Bitwise equality of a JAX and a torch array."""
    a = np.asarray(j, np.float32)
    b = t.detach().to(torch.float32).numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _tied_inputs(seed, shape=(6, 40)):
    """Multiples of 1/8 with power-of-two row maxima: for every bit width
    many elements sit exactly half-way between two grid levels, so the
    half-to-even tie rule is exercised."""
    r = np.random.default_rng(seed)
    x = r.integers(-32, 33, shape).astype(np.float32) / 8.0
    x[:, 0] = 4.0 * np.where(r.random(shape[0]) < 0.5, 1.0, -1.0)
    return x


@pytest.mark.parametrize("coding", CODINGS)
@pytest.mark.parametrize("bits", range(1, 9))
def test_plane_weights_and_range(coding, bits):
    np.testing.assert_array_equal(jq.plane_weights(bits, coding),
                                  tq.plane_weights(bits, coding))
    assert jq.int_range(bits, coding) == tq.int_range(bits, coding)


@pytest.mark.parametrize("mode", ["tensor", "axis0", "axis1", "row"])
@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("coding", CODINGS)
def test_quantize_grid_bitwise(coding, bits, mode):
    x = _tied_inputs(bits)
    kw = {"tensor": {}, "axis0": {"axis": 0}, "axis1": {"axis": 1},
          "row": {"per_row": True}}[mode]
    qj = jq.quantize(jnp.asarray(x), bits, coding, **kw)
    qt = tq.quantize(torch.from_numpy(x), bits, coding, **kw)
    _same(qj.q, qt.q)
    if coding == "xnor" and bits == 1:
        # the 1-bit XNOR scale is a float mean, a reduction whose
        # summation order differs between XLA and torch: equal to 1 ulp
        np.testing.assert_allclose(qt.scale.numpy(), np.asarray(qj.scale),
                                   rtol=2.5e-7)
    else:
        _same(qj.scale, qt.scale)


def test_quantize_rejects_axis_with_per_row():
    with pytest.raises(ValueError):
        tq.quantize(torch.zeros(2, 3), 4, "xnor", axis=0, per_row=True)


@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("coding", CODINGS)
def test_planes_bitwise_and_roundtrip(coding, bits):
    lo, hi = tq.int_range(bits, coding)
    r = np.random.default_rng(bits)
    if coding == "xnor":
        q = (2 * r.integers(lo // 2, hi // 2 + 1, (5, 7)) if bits > 1
             else r.choice([-1, 1], (5, 7)))
    else:
        q = r.integers(lo, hi + 1, (5, 7))
    q = q.astype(np.float32)
    pj = jq.int_to_planes(jnp.asarray(q), bits, coding)
    pt = tq.int_to_planes(torch.from_numpy(q), bits, coding)
    _same(pj, pt)
    _same(jnp.asarray(q), tq.planes_to_int(pt, bits, coding))


@pytest.mark.parametrize("adc_bits", [1, 3, 8])
@pytest.mark.parametrize("fs", [0.5, 7.0, 100.0, 2304.0, 1280.0])
def test_adc_bitwise(fs, adc_bits):
    # popcounts 0..fs plus out-of-range values, on a grid that puts many
    # scaled values exactly half-way between two codes
    p = np.concatenate([np.arange(-3, int(fs) + 4, dtype=np.float32),
                        np.arange(0, 64, dtype=np.float32) * fs / 63.0])
    cj = jadc.adc_convert(jnp.asarray(p), fs, adc_bits)
    ct = tadc.adc_convert(torch.from_numpy(p), fs, adc_bits)
    _same(cj, ct)
    _same(jadc.adc_quantize_sum(jnp.asarray(p), fs, adc_bits),
          tadc.adc_quantize_sum(torch.from_numpy(p), fs, adc_bits))


def test_adc_per_element_full_scale_bitwise():
    r = np.random.default_rng(3)
    p = r.integers(0, 300, (4, 9)).astype(np.float32)
    fs = r.integers(0, 300, (4, 1)).astype(np.float32)
    _same(jadc.adc_quantize_sum(jnp.asarray(p), jnp.asarray(fs)),
          tadc.adc_quantize_sum(torch.from_numpy(p), torch.from_numpy(fs)))


def test_adc_keyless_noise_warns():
    with pytest.warns(RuntimeWarning, match="NOISELESS"):
        tadc.adc_convert(torch.zeros(3), 10.0, 8, sigma_lsb=0.5)


@pytest.mark.parametrize("variant", [{}, {"adaptive_range": True},
                                     {"ideal_adc": True}, {"adc_bits": 4}])
@pytest.mark.parametrize("coding", CODINGS)
def test_gemm_adc_epilogue_bitwise(coding, variant):
    r = np.random.default_rng(4)
    nu = r.integers(0, 600, (8, 1)).astype(np.float32)
    d = r.integers(-600, 601, (8, 5)).astype(np.float32)
    if coding == "xnor":
        d = d - np.mod(d - nu, 2)          # d and nu share parity
    else:
        d = np.abs(d)
    jc = jbpbs.BpbsConfig(coding=coding, **variant)
    tc = tbpbs.BpbsConfig(coding=coding, **variant)
    _same(jbpbs.gemm_adc_epilogue(jnp.asarray(d), jnp.asarray(nu), 600.0, jc),
          tbpbs.gemm_adc_epilogue(torch.from_numpy(d), torch.from_numpy(nu),
                                  600.0, tc))


@pytest.mark.parametrize("coding,ba,bx,n,bank_n", [
    ("xnor", 4, 4, 300, 2304),
    ("xnor", 2, 3, 700, 256),          # three banks, ragged last one
    ("and", 3, 2, 500, 128),
    ("xnor", 1, 1, 256, 2304),
])
def test_bpbs_matmul_bitwise(coding, ba, bx, n, bank_n):
    r = np.random.default_rng(5)
    x = _tied_inputs(6, (5, n))
    w = r.normal(size=(n, 12)).astype(np.float32)
    qxj = jq.quantize(jnp.asarray(x), bx, coding)
    qwj = jq.quantize(jnp.asarray(w), ba, coding, axis=1)
    jc = jbpbs.BpbsConfig(ba=ba, bx=bx, coding=coding, bank_n=bank_n)
    tc = tbpbs.BpbsConfig(ba=ba, bx=bx, coding=coding, bank_n=bank_n)
    yj = jbpbs.bpbs_matmul_int(qxj.q, qwj.q, jc)
    yt = tbpbs.bpbs_matmul_int(torch.tensor(np.asarray(qxj.q)),
                               torch.tensor(np.asarray(qwj.q)), tc)
    _same(yj, yt)


def test_bpbs_whole_bank_skip_is_bit_identical():
    x = np.zeros((3, 600), np.float32)
    x[:, 300:] = _tied_inputs(7, (3, 300))          # bank 0 is all zero
    q = tq.quantize(torch.from_numpy(x), 4, "xnor").q
    w = tq.quantize(torch.randn(600, 8, generator=torch.Generator()
                                .manual_seed(0)), 4, "xnor", axis=1).q
    on = tbpbs.BpbsConfig(bank_n=256, skip_zero_planes=True)
    off = tbpbs.BpbsConfig(bank_n=256, skip_zero_planes=False)
    assert torch.equal(tbpbs.bpbs_matmul_int(q, w, on),
                       tbpbs.bpbs_matmul_int(q, w, off))


@pytest.mark.parametrize("act", ["relu", "sign", "identity", "silu", "gelu"])
@pytest.mark.parametrize("by_bits", [None, 16])
def test_postreduce_matches(act, by_bits):
    r = np.random.default_rng(8)
    y = (r.normal(size=(4, 6)) * 3e4).astype(np.float32)
    y[0, 0] = 0.0
    s = r.uniform(0.5, 2.0, 6).astype(np.float32)
    b = r.normal(size=6).astype(np.float32)
    yj = jdp.postreduce(jnp.asarray(y), jnp.asarray(s), jnp.asarray(b), act,
                        by_bits)
    yt = tdp.postreduce(torch.from_numpy(y), torch.from_numpy(s),
                        torch.from_numpy(b), act, by_bits)
    if act in ("silu", "gelu"):
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-6,
                                   atol=1e-6)
    else:
        _same(yj, yt)


def test_postreduce_program_fields():
    p = tdp.Postreduce(scale=torch.ones(3), act="relu", saturate=True)
    assert p.n_ops() == 3
    assert p.resolve_bits(2, 2) == 16 and p.resolve_bits(4, 4) == 32
    assert tdp.Postreduce(by_bits=8).resolve_bits(4, 4) == 8
    assert tdp.output_bits(4, 4) == jdp.output_bits(4, 4)
