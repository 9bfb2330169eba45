"""ADC noise, the cell-level CIMA model, ABN and the noise-robustness
recipe in the port, against the JAX package.

Every test feeds the same numpy inputs (from a seed) to the reference and
to the port.  What must match:

* Noiseless grids — ``n_levels``, ``cell_outputs``, ``column_popcount``,
  ``adc_convert``/``adc_quantize_sum``, ``abn_binarize`` at sigma 0,
  ``abn_threshold_code`` and the BP/BS outputs of ``bpbs``: bitwise.
  The physics path (``bpbs_matmul_int_reference``, backend
  ``bpbs_ref``) against the fast path: atol 1e-4, the reference's own
  tolerance (both are integer-valued; the bound is what the reference
  states).
* ADC noise (sigma > 0): JAX's PRNG cannot be reproduced in torch, so
  the port matches in distribution.  At fs = 255 a clean code sits on
  the integer popcount and the code shift ``e = round(sigma z)`` has
  ``P(e = 0) = 2 Phi(0.5 / sigma) - 1`` and ``P(e = +1) = P(e = -1)``;
  both packages' histograms over 2^16 samples are held within 5
  binomial standard deviations of those.  The BP/BS error of ``y`` in the
  integer domain then has variance ``4 Var(e) sum wx^2 sum wa^2`` per
  bank; the port's is held within 5% (about 9 standard errors of the
  sample variance at 131,072 outputs).
* Determinism in the seed, and uncorrelated noise across dispatches of
  one scope: |corr| below 5 / sqrt(samples).
* Remat: under ``noise_aware`` the recomputed layers draw the noise
  their forward drew, so gradients with remat on and off are bitwise
  equal.
"""
import dataclasses
import math
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import accel as jaccel
from repro.configs import NETWORK_A as JNET_A
from repro.core import adc as jadc
from repro.core import bpbs as jbpbs
from repro.core import cima as jcima
from repro.core import quant as jquant
from repro.models import cnn as jcnn
from repro.optim import qat as jqat
from repro_torch import accel as taccel
from repro_torch.accel import context as tcontext
from repro_torch.configs import NETWORK_A as TNET_A
from repro_torch.configs import NETWORK_B as TNET_B
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.core import adc as tadc
from repro_torch.core import bpbs as tbpbs
from repro_torch.core import cima as tcima
from repro_torch.core import quant as tquant
from repro_torch.core.quant import Coding
from repro_torch.optim import qat as tqat

ROOT = Path(__file__).resolve().parents[1]
CODINGS = [Coding.XNOR, Coding.AND]
SIGMA = 0.3
# the code shift at fs = 255 and sigma = 0.3: P(|0.3 z| >= 0.5) / 2 each
P_SHIFT = 0.5 * math.erfc(0.5 / SIGMA / math.sqrt(2.0))        # 0.04779
P_ZERO = 1.0 - 2.0 * P_SHIFT                                   # 0.90442
VAR_E = 2.0 * P_SHIFT                                          # 0.09558


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _operands(rng, coding, ba, bx, n, m, batch=4, sparsity=0.0):
    """Integer-grid operands, as tests/test_core_bpbs.py makes them."""
    lo_x, hi_x = jquant.int_range(bx, coding)
    lo_w, hi_w = jquant.int_range(ba, coding)
    if coding == Coding.XNOR:
        x = (2 * rng.integers(lo_x // 2, hi_x // 2 + 1, (batch, n))
             if bx > 1 else rng.choice([-1, 1], (batch, n)))
        w = (2 * rng.integers(lo_w // 2, hi_w // 2 + 1, (n, m))
             if ba > 1 else rng.choice([-1, 1], (n, m)))
    else:
        x = rng.integers(lo_x, hi_x + 1, (batch, n))
        w = rng.integers(lo_w, hi_w + 1, (n, m))
    if sparsity > 0 and not (coding == Coding.XNOR and bx == 1):
        x = x * (rng.random((batch, n)) > sparsity)
    return x.astype(np.float32), w.astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _to_port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


# ------------------------------------------------------ noiseless grids

@pytest.mark.parametrize("coding", CODINGS)
def test_n_levels_equal_reference(coding):
    for bits in range(1, 9):
        assert tquant.n_levels(bits, coding) == jquant.n_levels(
            bits, jquant.Coding(coding.value))


@pytest.mark.parametrize("coding", CODINGS)
def test_cell_model_bitwise_equal_to_reference(coding):
    rng = np.random.default_rng(1)
    x, w = _operands(rng, coding, ba=2, bx=2, n=40, m=6, batch=3,
                     sparsity=0.3)
    jcfg = jbpbs.BpbsConfig(ba=2, bx=2, coding=coding.value)
    a = np.asarray(jbpbs.weight_planes(jnp.asarray(w), jcfg))[..., 0]
    xp = np.asarray(jquant.int_to_planes(jnp.asarray(x), 2, coding.value))
    mask = (x != 0).astype(np.float32)
    for kx in range(2):
        got_o = tcima.cell_outputs(_t(a), _t(xp[..., kx]), _t(mask), coding)
        want_o = jcima.cell_outputs(a, xp[..., kx], mask, coding.value)
        np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
        got_p = tcima.column_popcount(_t(a), _t(xp[..., kx]), _t(mask),
                                      coding)
        want_p = jcima.column_popcount(a, xp[..., kx], mask, coding.value)
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


def test_abn_noiseless_and_threshold_code_bitwise_equal_to_reference():
    p = np.arange(0.0, 2305.0, dtype=np.float32)
    for code in (0.0, 8.0, 31.0, 32.0, 63.0):
        for fs in (255.0, 2304.0, 100.0):
            np.testing.assert_array_equal(
                tadc.abn_binarize(_t(p), code, fs).numpy(),
                np.asarray(jadc.abn_binarize(p, code, fs)))
    tp = np.linspace(-10.0, 2400.0, 997).astype(np.float32)
    for fs in (255.0, 2304.0, 7.0):
        np.testing.assert_array_equal(
            tadc.abn_threshold_code(_t(tp), fs).numpy(),
            np.asarray(jadc.abn_threshold_code(tp, fs)))


def test_sigma_corner_table():
    assert tadc.SIGMA_LSB_CORNER == jadc.SIGMA_LSB_CORNER
    assert set(tadc.SIGMA_LSB_CORNER) == {1.2, 0.85}
    assert tadc.SIGMA_LSB_CORNER[0.85] > tadc.SIGMA_LSB_CORNER[1.2] > 0


# ------------------------------------------- ports of test_core_bpbs.py

@pytest.mark.parametrize("coding", CODINGS)
@pytest.mark.parametrize("adaptive", [
    False, pytest.param(True, marks=pytest.mark.slow)])
def test_fast_path_equals_cell_physics(coding, adaptive):
    """The GEMM-identity path == the capacitor-level CIMA model, ADC,
    banking and sparsity masking included; both equal the reference's."""
    rng = np.random.default_rng(7)
    x, w = _operands(rng, coding, ba=3, bx=2, n=400, m=8, sparsity=0.3)
    cfg = tbpbs.BpbsConfig(ba=3, bx=2, coding=coding, bank_n=256,
                           adaptive_range=adaptive)
    jcfg = jbpbs.BpbsConfig(ba=3, bx=2, coding=coding.value, bank_n=256,
                            adaptive_range=adaptive)
    y1 = tbpbs.bpbs_matmul_int(_t(x), _t(w), cfg).numpy()
    y2 = tbpbs.bpbs_matmul_int_reference(_t(x), _t(w), cfg).numpy()
    np.testing.assert_allclose(y1, y2, atol=1e-4)
    np.testing.assert_array_equal(
        y1, np.asarray(jbpbs.bpbs_matmul_int(x, w, jcfg)))
    np.testing.assert_allclose(
        y2, np.asarray(jbpbs.bpbs_matmul_int_reference(x, w, jcfg)),
        atol=1e-4)


def test_adc_monotone_and_idempotent():
    p = torch.arange(0, 2305, dtype=torch.float32)
    q = tadc.adc_quantize_sum(p, 2304.0)
    assert bool(torch.all(torch.diff(q) >= 0)), "ADC transfer must be monotone"
    assert torch.equal(tadc.adc_quantize_sum(q, 2304.0), q)
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(jadc.adc_quantize_sum(p.numpy(), 2304.0)))
    # exact for fs <= 255
    p2 = torch.arange(0, 200, dtype=torch.float32)
    assert torch.equal(tadc.adc_quantize_sum(p2, 199.0), p2)


def test_abn_threshold():
    p = torch.arange(0.0, 256.0)
    out = tadc.abn_binarize(p, threshold_code=32.0, full_scale=255.0)
    # 6-b DAC: threshold = 32/63*255 = 129.5
    assert float(out[129]) == -1.0 and float(out[130]) == 1.0
    assert set(np.unique(out.numpy())) <= {-1.0, 1.0}
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jadc.abn_binarize(p.numpy(), 32.0, 255.0)))


def test_accel_adc_noise_matches_analytic_bound():
    """At N=512 (> 255) the ADC adds quantization noise whose magnitude
    matches the analytic model (the reference's bounds); the port's chip
    output equals the reference's bitwise."""
    rng = np.random.default_rng(0)
    n, m, ba, bx = 512, 64, 4, 4
    x = rng.normal(size=(64, n)).astype(np.float32)
    w = rng.normal(size=(n, m)).astype(np.float32)
    y_int = taccel.matmul(_t(x), _t(w),
                          taccel.ExecSpec(backend="digital_int", ba=ba, bx=bx))
    y_chip = taccel.matmul(_t(x), _t(w), taccel.ExecSpec(
        backend="bpbs", ba=ba, bx=bx, bank_n=512))
    want = jaccel.matmul(jnp.asarray(x), jnp.asarray(w), jaccel.ExecSpec(
        backend="bpbs", ba=ba, bx=bx, bank_n=512))
    np.testing.assert_allclose(y_chip.numpy(), np.asarray(want), rtol=1e-6)
    qx = tquant.quantize(_t(x), bx, Coding.XNOR)
    qw = tquant.quantize(_t(w), ba, Coding.XNOR, axis=1)
    step = n / 255.0
    wsum = float(np.sum(tquant.plane_weights(ba, Coding.XNOR) ** 2)) * \
        float(np.sum(tquant.plane_weights(bx, Coding.XNOR) ** 2))
    pred_var = wsum * 4.0 * step ** 2 / 12.0
    err_int = (y_chip - y_int) / (qx.scale * qw.scale.reshape(1, -1))
    meas_var = float(torch.mean(err_int ** 2))
    assert 0.1 * pred_var < meas_var < 8.0 * pred_var, (meas_var, pred_var)


def test_bpbs_ref_backend_equals_bpbs_and_reference():
    """``bpbs_ref`` (cell by cell) against the port's ``bpbs`` and the
    reference's ``bpbs_ref`` at sigma 0, through ``accel.matmul``, with a
    fused epilogue on a second call."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 300)).astype(np.float32)
    w = rng.normal(size=(300, 12)).astype(np.float32)
    kw = dict(ba=3, bx=2, bank_n=128)
    got = taccel.matmul(_t(x), _t(w), taccel.ExecSpec(backend="bpbs_ref", **kw))
    fast = taccel.matmul(_t(x), _t(w), taccel.ExecSpec(backend="bpbs", **kw))
    want = jaccel.matmul(jnp.asarray(x), jnp.asarray(w),
                         jaccel.ExecSpec(backend="bpbs_ref", **kw))
    np.testing.assert_allclose(got.numpy(), fast.numpy(), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    post = taccel.Postreduce(scale=0.5, bias=0.25, act="relu")
    with torch.no_grad():
        fused = taccel.matmul(_t(x), _t(w),
                              taccel.ExecSpec(backend="bpbs_ref", **kw),
                              post=post)
    assert torch.equal(fused, post.apply(got, 2, 3))
    assert "bpbs_ref" in taccel.list_backends()


# -------------------------------------------------- keyless noise warns

def test_keyless_sigma_warns_not_silent():
    """adc_sigma_lsb > 0 with no generator runs noiseless but warns; the
    noiseless codes equal the reference's."""
    d = (np.random.default_rng(6).normal(size=(4, 8)) * 30).astype(np.float32)
    with pytest.warns(RuntimeWarning, match="NOISELESS"):
        y = tadc.adc_convert(_t(d), 64, sigma_lsb=0.5, generator=None)
    assert torch.equal(y, tadc.adc_convert(_t(d), 64, sigma_lsb=0.0))
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jadc.adc_convert(d, 64, sigma_lsb=0.0)))
    with pytest.warns(RuntimeWarning, match="NOISELESS"):
        tadc.abn_binarize(_t(d), 32.0, 64.0, sigma_lsb=0.5)
    with warnings.catch_warnings():
        warnings.simplefilter("error")             # no warning with a generator
        tadc.adc_convert(_t(d), 64, sigma_lsb=0.5,
                         generator=torch.Generator().manual_seed(0))
        tadc.adc_convert(_t(d), 64, sigma_lsb=0.0, generator=None)


# ----------------------------------------- noise statistics (sigma > 0)

def _shift_histogram_ok(e: np.ndarray) -> None:
    n = e.size
    for value, prob in ((0, P_ZERO), (1, P_SHIFT), (-1, P_SHIFT)):
        count = int(np.sum(e == value))
        sd = math.sqrt(n * prob * (1.0 - prob))
        assert abs(count - n * prob) < 5.0 * sd, (value, count, n * prob)
    assert np.all(np.abs(e) <= 2)


def test_code_shift_histogram_port_and_reference():
    """Both packages' ADC code shifts at fs = 255, sigma = 0.3, over 2^16
    integer popcounts, lie within 5 binomial standard deviations of the
    analytic distribution."""
    p = np.random.default_rng(3).integers(20, 236, 1 << 16).astype(np.float32)
    got = tadc.adc_convert(_t(p), 255.0, sigma_lsb=SIGMA,
                           generator=torch.Generator().manual_seed(1))
    want = jadc.adc_convert(jnp.asarray(p), 255.0, sigma_lsb=SIGMA,
                            key=jax.random.PRNGKey(1))
    _shift_histogram_ok(got.numpy() - p)
    _shift_histogram_ok(np.asarray(want) - p)
    # noise with the default scale of the ABN: sigma LSBs of fs / 255
    flips = tadc.abn_binarize(_t(p), 32.0, 255.0, sigma_lsb=SIGMA,
                              generator=torch.Generator().manual_seed(2))
    assert not torch.equal(flips, tadc.abn_binarize(_t(p), 32.0, 255.0))


def _noise_operands(batch=1024, n=255, m=128, seed=4):
    r = np.random.default_rng(seed)
    return (_t(r.normal(size=(batch, n)).astype(np.float32)),
            _t(r.normal(size=(n, m)).astype(np.float32)))


NOISY = taccel.ExecSpec(backend="bpbs", ba=4, bx=4, bank_n=255,
                        adc_sigma_lsb=SIGMA)


def _int_error(x, w, y, y0):
    qx = tquant.quantize(x, NOISY.bx, Coding.XNOR)
    qw = tquant.quantize(w, NOISY.ba, Coding.XNOR, axis=1)
    return (y - y0) / (qx.scale * qw.scale.reshape(1, -1))


def test_bpbs_noise_variance_matches_analytic():
    """One bank of 255 rows (fs = 255, the clean ADC exact): the error of
    ``y`` in the integer domain is ``2 sum wx wa e`` with independent
    code shifts, variance ``4 Var(e) sum wx^2 sum wa^2``."""
    x, w = _noise_operands()
    clean = dataclasses.replace(NOISY, adc_sigma_lsb=0.0)
    y0 = taccel.matmul(x, w, clean)
    with taccel.adc_noise(5):
        y = taccel.matmul(x, w, NOISY)
    err = _int_error(x, w, y, y0)
    wsum = float(np.sum(tquant.plane_weights(4, Coding.XNOR) ** 2)) ** 2
    pred = 4.0 * VAR_E * wsum
    meas = float(torch.mean(err ** 2))
    assert abs(meas / pred - 1.0) < 0.05, (meas, pred)
    assert abs(float(torch.mean(err))) < 5.0 * math.sqrt(pred / err.numel())


def test_noise_deterministic_in_seed_and_independent_across_dispatches():
    x, w = _noise_operands(batch=256)
    clean = dataclasses.replace(NOISY, adc_sigma_lsb=0.0)
    y0 = taccel.matmul(x, w, clean)
    runs = []
    for seed in (9, 9, 10):
        with taccel.adc_noise(seed):
            runs.append((taccel.matmul(x, w, NOISY),
                         taccel.matmul(x, w, NOISY)))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert not torch.equal(runs[0][0], runs[2][0])
    a, b = (_int_error(x, w, y, y0).ravel() for y in runs[0])
    assert not torch.equal(a, b)
    corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
    assert abs(corr) < 5.0 / math.sqrt(a.numel()), corr
    # outside any scope: no generator, so sigma > 0 warns and is noiseless
    with pytest.warns(RuntimeWarning, match="NOISELESS"):
        assert torch.equal(taccel.matmul(x, w, NOISY), y0)


def test_adc_noise_scope_counts_dispatches():
    """Each dispatch takes the next counter of the innermost scope; the
    generator of dispatch k depends only on (seed, k)."""
    with taccel.adc_noise(3):
        g1 = tcontext.next_noise_generator()
        g2 = tcontext.next_noise_generator()
        with taccel.adc_noise(3):
            h1 = tcontext.next_noise_generator()
    assert tcontext.next_noise_generator() is None
    draw = lambda g: torch.randn(8, generator=g)            # noqa: E731
    a, b, c = draw(g1), draw(g2), draw(h1)
    assert torch.equal(a, c) and not torch.equal(a, b)


def test_remat_replays_noise_bitwise():
    """Under ``noise_aware`` a reduced olmo-1b loss on ``bpbs`` gives the
    same loss and gradients with remat on and off, bitwise: the
    recomputed layers (run after the scope closed) see its overrides and
    draw the noise their forward drew.  The noise is live: the loss
    differs from the noiseless one."""
    from repro.configs import get_config as jget
    from repro.data.pipeline import DataConfig as JData
    from repro.data.pipeline import make_batch as jbatch
    from repro.models import init_params as jinit
    from repro_torch.models import loss_fn
    from repro_torch.tree import leaves
    from repro_torch.train.step import value_and_grad

    jc = jget("olmo-1b").reduced()
    params = _to_port(jinit(jc, jax.random.PRNGKey(0)))
    tc = tget("olmo-1b").reduced().with_accel("bpbs", ba=4, bx=4)
    b = jbatch(JData(seq_len=8, global_batch=2, vocab=jc.vocab, seed=0), 0)
    batch = {k: _t(v) for k, v in b.items()}

    def run(remat, sigma):
        cfg = dataclasses.replace(tc, remat=remat)

        def f(p):
            with tqat.noise_aware(21, sigma):
                return loss_fn(p, batch, cfg)
        return value_and_grad(f, params)

    (l_off, _), g_off = run(False, SIGMA)
    (l_on, _), g_on = run(True, SIGMA)
    assert float(l_on) == float(l_off)
    for a, c in zip(leaves(g_on), leaves(g_off)):
        assert torch.equal(a, c)
    (l_clean, _), _ = run(True, 0.0)
    assert float(l_clean) != float(l_on)
    assert not tcontext._NOISE_STACK and not tcontext._OVERRIDE_STACK


# -------------------------------------- noise-aware QAT and calibration

def test_calibrate_bn_stats_recenters_under_noise():
    """The calibration pass re-estimates BN running statistics under live
    ADC noise through ``bpbs``: the statistics move away from the
    noiseless calibration's (which equals the reference's), everything
    else in the params is untouched, and the result is deterministic in
    the seed."""
    net = TNET_A.reduced()
    pj = jcnn.init_cnn(jax.random.PRNGKey(0), JNET_A.reduced())
    params = _to_port(pj)
    rng = np.random.default_rng(7)
    images = [rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
              for _ in range(2)]
    batches = [{"images": _t(i)} for i in images]
    cal = tqat.calibrate_bn_stats(params, batches, net, 1, sigma_lsb=SIGMA)
    clean = tqat.calibrate_bn_stats(params, batches, net, 1, sigma_lsb=0.0)
    want = jqat.calibrate_bn_stats(pj, [{"images": jnp.asarray(i)}
                                        for i in images], JNET_A.reduced(),
                                   jax.random.PRNGKey(1), sigma_lsb=0.0)
    moved = 0.0
    for p, q, c, jw in zip(params["layers"], cal["layers"], clean["layers"],
                           want["layers"]):
        assert float((q["bn_mean"] - p["bn_mean"]).abs().max()) > 0
        assert torch.equal(p["w"], q["w"])
        assert torch.equal(p["bn_scale"], q["bn_scale"])
        moved = max(moved, float((q["bn_mean"] - c["bn_mean"]).abs().max()))
        for k in ("bn_mean", "bn_var"):
            ref = np.asarray(jw[k])
            np.testing.assert_allclose(c[k].numpy(), ref, rtol=0,
                                       atol=1e-4 * np.abs(ref).max())
    assert moved > 0, "the calibration drew no noise"
    cal2 = tqat.calibrate_bn_stats(params, batches, net, 1, sigma_lsb=SIGMA)
    assert torch.equal(cal["layers"][0]["bn_mean"],
                       cal2["layers"][0]["bn_mean"])


@pytest.mark.parametrize("net", [TNET_A, TNET_B], ids=["a", "b"])
def test_noise_aware_qat_step_draws_noise_and_launches_no_kernel(net,
                                                                 monkeypatch):
    """The latent fault of the port's kernel-named CIFAR policies: the
    ``--noise-sigma`` QAT step must draw noise (its loss differs from the
    noiseless step's for the same parameters and batch) and must not
    reach the kernel backend, which takes no noise; a kernel dispatch
    under sigma > 0 warns NOISELESS."""
    from repro_torch.accel import backends, registry
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models.cnn import init_cnn
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.cifar_qat import qat_update

    net = net.reduced()
    calls = []

    def counted(*a):
        calls.append(1)
        return backends.kernel(*a)

    monkeypatch.setitem(registry._BACKENDS, "kernel", counted)
    params = init_cnn(0, net, device="cpu")
    batch = make_batch(DataConfig(kind="cifar_synthetic", global_batch=4,
                                  seed=1), 0, "cpu")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2,
                          weight_decay=0.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, _, noisy = qat_update(params, init_opt_state(params), batch, net,
                                 opt_cfg, SIGMA, 5)
        _, _, again = qat_update(params, init_opt_state(params), batch, net,
                                 opt_cfg, SIGMA, 5)
    assert not calls
    assert float(noisy["loss"]) == float(again["loss"])
    _, _, clean = qat_update(params, init_opt_state(params), batch, net,
                             opt_cfg)
    assert len(calls) == len(net.layers)
    assert float(noisy["loss"]) != float(clean["loss"])
    with pytest.warns(RuntimeWarning, match="NOISELESS"), \
            tqat.noise_aware(5, SIGMA):
        taccel.matmul(torch.ones(2, 27), torch.ones(27, 4),
                      taccel.ExecSpec(backend="kernel", ba=4, bx=4))


def test_cifar_qat_cli_with_noise_sigma(capsys):
    from repro_torch.train import cifar_qat

    cifar_qat.main(["--net", "b", "--steps", "2", "--batch", "4",
                    "--device", "cpu", "--noise-sigma", str(SIGMA)])
    out = capsys.readouterr().out
    assert "noisy (sigma=0.3 LSB, bpbs): uncalibrated=" in out
    assert "calibrated=" in out


@pytest.mark.slow
def test_cifar_accuracy_holds_at_085v_corner():
    """Acceptance: CIFAR eval accuracy under the 0.85 V corner's ADC noise
    within 1% of the noiseless chip model after noise-aware QAT and BN
    recalibration (paper Fig. 10/11 robustness); the reference's recipe,
    from the reference's initial parameters."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.cifar_qat import fig11_accuracy, qat_update

    sigma = tadc.SIGMA_LSB_CORNER[0.85]
    net = TNET_A.reduced()
    data_cfg = DataConfig(kind="cifar_synthetic", global_batch=32, seed=1)
    steps = 60
    params = _to_port(jcnn.init_cnn(jax.random.PRNGKey(0), JNET_A.reduced()))
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=steps,
                          weight_decay=0.0)
    opt = init_opt_state(params)
    for step in range(steps):
        params, opt, _ = qat_update(params, opt,
                                    make_batch(data_cfg, step, "cpu"), net,
                                    opt_cfg, sigma, tcontext.fold_seed(0, step))
    eval_batches = [make_batch(data_cfg, 10_000 + i, "cpu") for i in range(8)]
    cal = tqat.calibrate_bn_stats(
        params, [make_batch(data_cfg, 20_000 + i, "cpu") for i in range(8)],
        net, 7, sigma)
    clean = fig11_accuracy(params, eval_batches, net, "bpbs")
    noisy = sum(fig11_accuracy(cal, eval_batches, net, "bpbs", sigma, k)
                for k in (11, 12, 13)) / 3
    assert clean > 0.5, f"training failed to learn: {clean}"
    assert noisy >= clean - 0.01, (
        f"0.85V-corner accuracy {noisy:.3f} fell >1% below noiseless "
        f"{clean:.3f} after calibration")


# ------------------------------------------------------- figure checks

def test_figures_run_on_cpu_and_match_reference_rows(capsys, monkeypatch):
    """``repro_torch.figures.run`` passes every paper assertion; the rows
    that draw no random operands (Figs. 8 and 11, Fig. 10's transfer
    functions) equal the reference benchmarks' rows."""
    from repro_torch.figures import run as fig_run

    assert fig_run.run_all("cpu") == []
    rows = capsys.readouterr().out.splitlines()
    assert rows[0] == "name,us_per_call,derived"
    got = dict(r.split(",", 1) for r in rows[1:])
    assert sum(k.startswith("fig7_sqnr_") for k in got) == 57

    monkeypatch.syspath_prepend(str(ROOT))
    from benchmarks import fig8_bandwidth, fig10_transfer, fig11_networks

    for mod in (fig8_bandwidth, fig11_networks, fig10_transfer):
        mod.run()
    want = dict(r.split(",", 1) for r in capsys.readouterr().out.splitlines())
    same = [k for k in want if not k.startswith("fig10_multibit")]
    assert len(same) == 28
    for k in same:
        assert got[k] == want[k], k
    for k in want:
        if k.startswith("fig10_multibit"):
            corr = float(got[k].split("corr=")[1])
            assert corr > 0.99
