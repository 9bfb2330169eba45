"""The port's CUDA kernels on the card, held to their plain torch versions.

Every test here needs an NVIDIA GPU and skips without one (the kernels
have no CPU mode).  The file imports nothing of ``jax`` or ``repro``, so
it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports the JAX package.)
Without the fused epilogue the cima_mvm kernel must equal the plain
version bit for bit; with it, the kernel's ``expf``/``tanhf`` may round
differently from torch's silu/gelu by a few float32 ulps: rtol/atol 1e-6.
The flash kernel sums its f32 scores and PV products in another order
than the plain version: f32 atol 2e-5, the reference's own.  In bf16 both
round the same f32 function once, so an element differs by at most one
bf16 ulp: |o - ref| <= 2**-7 |ref| + 1e-5, and within the reference's
atol 2e-2.
"""
import numpy as np
import pytest
import torch

from repro_torch import accel
from repro_torch.configs import NETWORK_A, NETWORK_B, get_config
from repro_torch.core import sqnr
from repro_torch.core.bpbs import BpbsConfig
from repro_torch.core.quant import Coding, int_range
from repro_torch.kernels import cima_mvm as K
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import init_params
from repro_torch.models.cnn import cnn_forward, init_cnn
from repro_torch import tree
from repro_torch.serve import (ContinuousBatcher, Engine, PagedScheduler,
                               ServeConfig)

pytestmark = pytest.mark.cuda

CASES = [
    # (coding, ba, bx, n, m, bank_n): the CIMA_CASES of tests/test_kernels.py
    (Coding.XNOR, 4, 4, 300, 40, 2304), (Coding.XNOR, 1, 1, 256, 32, 2304),
    (Coding.XNOR, 2, 3, 512, 16, 256), (Coding.XNOR, 8, 8, 100, 8, 2304),
    (Coding.XNOR, 4, 2, 2400, 24, 2304), (Coding.AND, 4, 4, 300, 40, 2304),
    (Coding.AND, 2, 2, 512, 16, 128), (Coding.AND, 6, 3, 700, 12, 512),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _planes(case, variant, device, batch=5, seed=0, sparsity=0.3):
    """Integer-grid operands as tests/test_kernels.py makes them, as planes."""
    coding, ba, bx, n, m, bank_n = case
    r = np.random.default_rng(seed)
    lo_x, hi_x = int_range(bx, coding)
    lo_w, hi_w = int_range(ba, coding)
    if coding == Coding.XNOR:
        x = (2 * r.integers(lo_x // 2, hi_x // 2 + 1, (batch, n))
             if bx > 1 else r.choice([-1, 1], (batch, n)))
        w = (2 * r.integers(lo_w // 2, hi_w // 2 + 1, (n, m))
             if ba > 1 else r.choice([-1, 1], (n, m)))
    else:
        x = r.integers(lo_x, hi_x + 1, (batch, n))
        w = r.integers(lo_w, hi_w + 1, (n, m))
    if not (coding == Coding.XNOR and bx == 1):
        x = x * (r.random((batch, n)) > sparsity)
    cfg = BpbsConfig(ba=ba, bx=bx, coding=coding, bank_n=bank_n,
                     **(variant or {}))
    xs, nu, _ = K.prepare_inputs(torch.tensor(x, dtype=torch.float32,
                                              device=device), cfg)
    ws, fs = K.prepare_weights(torch.tensor(w, dtype=torch.float32,
                                            device=device), cfg)
    return xs, ws, nu, fs, cfg


@pytest.mark.parametrize("variant", [None, {"adaptive_range": True},
                                     {"ideal_adc": True}])
@pytest.mark.parametrize("case", CASES)
def test_kernel_equals_plain_version(cuda, case, variant):
    xs, ws, nu, fs, cfg = _planes(case, variant, cuda)
    before = K.cima_mvm_planes.launches
    y = K.cima_mvm_planes(xs, ws, nu, fs, cfg)
    torch.cuda.synchronize()
    assert K.cima_mvm_planes.launches == before + 1
    assert torch.equal(y, K.cima_mvm_planes_reference(xs, ws, nu, fs, cfg))


@pytest.mark.parametrize("rows", [1, 5])
@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu", "sign",
                                 "identity"])
def test_kernel_fused_epilogue(cuda, act, rows):
    xs, ws, nu, fs, cfg = _planes(CASES[4], None, cuda)
    m = ws.shape[2]
    g = torch.Generator(device=cuda).manual_seed(0)
    es = torch.rand(rows, m, generator=g, device=cuda) * 1e-3
    pb = torch.randn(m, generator=g, device=cuda)
    y = K.cima_mvm_planes(xs, ws, nu, fs, cfg, es, pb, act, 16)
    yr = K.cima_mvm_planes_reference(xs, ws, nu, fs, cfg, es, pb, act, 16)
    torch.testing.assert_close(y, yr, rtol=1e-6, atol=1e-6)


EDGE_CASES = [
    # (coding, ba, bx, n, m, bank_n): edges of the kernel's tiling.  A
    # ragged last bank (2400 = 2304 + 96) with B_X = 3 and M = 100 (byte
    # copies); AND with N = 1000 (byte copies of xs), M = 80 (16-byte
    # weight copies, a partial 64-column tile); B_X = B_A = 8 over three
    # banks; a decode-like shape with 16-byte copies, four banks and a
    # ragged last bank of 1280 rows
    (Coding.XNOR, 4, 3, 2400, 100, 2304),
    (Coding.AND, 3, 5, 1000, 80, 512),
    (Coding.XNOR, 8, 8, 640, 72, 256),
    (Coding.XNOR, 4, 4, 8192, 192, 2304),
]


def _force_cluster(monkeypatch, cluster):
    """Make the wrapper launch with ``cluster`` blocks per cluster and the
    launcher's own row tiling (None: the launcher's pick)."""
    if cluster is None:
        return
    pick = K.launch_shape
    monkeypatch.setattr(K, "launch_shape", lambda *shape:
                        pick(*shape)[:2] + (cluster,))


@pytest.mark.parametrize("cluster", [None, 1, 2, 4])
@pytest.mark.parametrize("batch", [1, 5, 16, 33])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_kernel_tiling_edges_equal_plain_version(cuda, monkeypatch, case,
                                                 batch, cluster):
    """B*B_X not a multiple of 16, M not a multiple of the 64-column tile,
    ragged banks, AND coding, B_X = B_A = 8, and every cluster size the
    launcher can pick: the integer partials sum in any order, so each must
    give the same bits."""
    xs, ws, nu, fs, cfg = _planes(case, None, cuda, batch=batch)
    _force_cluster(monkeypatch, cluster)
    y = K.cima_mvm_planes(xs, ws, nu, fs, cfg)
    torch.cuda.synchronize()
    assert torch.equal(y, K.cima_mvm_planes_reference(xs, ws, nu, fs, cfg))


@pytest.mark.parametrize("cluster", [1, 4])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_kernel_tiling_edges_fused(cuda, monkeypatch, case, cluster):
    xs, ws, nu, fs, cfg = _planes(case, None, cuda, batch=33)
    m = ws.shape[2]
    g = torch.Generator(device=cuda).manual_seed(1)
    es = torch.rand(33, m, generator=g, device=cuda) * 1e-3
    pb = torch.randn(m, generator=g, device=cuda)
    _force_cluster(monkeypatch, cluster)
    y = K.cima_mvm_planes(xs, ws, nu, fs, cfg, es, pb, "silu", 16)
    yr = K.cima_mvm_planes_reference(xs, ws, nu, fs, cfg, es, pb, "silu", 16)
    torch.testing.assert_close(y, yr, rtol=1e-6, atol=1e-6)


def _cifar_shapes():
    """Every layer shape of the paper's CIFAR networks as (name, ba, bx, n,
    m, act): N = 27 first convs, M = 10 classifiers, Network B's 1-b/1-b
    layers with the fused sign and its 16384-row (8-bank) FC."""
    out = {}
    for net in (NETWORK_A, NETWORK_B):
        act = "sign" if net.readout == "abn" else "relu"
        for i, layer in enumerate(net.layers):
            n = layer.cin * (9 if layer.kind == "conv" else 1)
            last = i == len(net.layers) - 1
            shape = (net.ba, net.bx, n, layer.cout, None if last else act)
            out.setdefault(shape, f"{net.name}.layer{i}")
    return [(name,) + shape for shape, name in out.items()]


CIFAR_SHAPES = _cifar_shapes()


def _cifar_planes(ba, bx, n, m, rows, device, seed=0):
    """Integer-grid XNOR operands made on the card (65,536 rows of a
    16384-wide input do not fit a host-side draw), as planes."""
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(bits, shape):
        if bits == 1:
            return torch.randint(0, 2, shape, generator=g,
                                 device=device) * 2.0 - 1.0
        lo, hi = int_range(bits, Coding.XNOR)
        return 2.0 * torch.randint(lo // 2, hi // 2 + 1, shape, generator=g,
                                   device=device)

    cfg = BpbsConfig(ba=ba, bx=bx)
    x = draw(bx, (rows, n))
    if bx > 1:
        x = x * (torch.rand(rows, n, generator=g, device=device) > 0.4)
    xs, nu, _ = K.prepare_inputs(x, cfg)
    ws, fs = K.prepare_weights(draw(ba, (n, m)), cfg)
    escale = torch.rand(m, generator=g, device=device) * 1e-2
    pbias = torch.randn(m, generator=g, device=device) * 3.0
    return xs, ws, nu, fs, cfg, escale, pbias


@pytest.mark.parametrize("rows", [1024, 65536])
@pytest.mark.parametrize("case", CIFAR_SHAPES, ids=lambda c: c[0])
def test_kernel_at_cifar_layer_shapes(cuda, case, rows):
    """Each CIFAR layer shape against the plain version: bitwise without
    the epilogue, and with its fused per-column BN scale/bias, activation
    and B_y saturation within rtol/atol 1e-6 (relu and sign are exact, so
    those are bitwise too)."""
    _, ba, bx, n, m, act = case
    xs, ws, nu, fs, cfg, es, pb = _cifar_planes(ba, bx, n, m, rows, cuda)
    y = K.cima_mvm_planes(xs, ws, nu, fs, cfg)
    torch.cuda.synchronize()
    assert torch.equal(y, K.cima_mvm_planes_reference(xs, ws, nu, fs, cfg))
    by = 16 if bx + ba <= 5 else 32
    y = K.cima_mvm_planes(xs, ws, nu, fs, cfg, es, pb, act, by)
    yr = K.cima_mvm_planes_reference(xs, ws, nu, fs, cfg, es, pb, act, by)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, yr, rtol=1e-6, atol=1e-6)
    assert torch.equal(y, yr)
    if act == "sign":
        assert set(torch.unique(y).tolist()) <= {-1.0, 1.0}


# the recurrent families' new projection shapes (name, N, M, fused act):
# column counts off the 16-wide tile (mamba2's in_proj M = 3,352 and its
# 50,280-word unembed), two ragged banks (4,096 = 2,304 + 1,792 rows),
# six banks (12,288) and the 256-wide MQA k/v of recurrentgemma-9b
RECURRENT_SHAPES = [
    ("mamba2.in_proj", 768, 3352, None), ("mamba2.out_proj", 1536, 768, None),
    ("mamba2.unembed", 768, 50280, None), ("rec.in_gate", 4096, 4096, "gelu"),
    ("attn.kv", 4096, 256, None), ("mlp.down", 12288, 4096, None),
    ("mlp.gate", 4096, 12288, "gelu"),
]


@pytest.mark.parametrize("rows", [4, 128])
@pytest.mark.parametrize("case", RECURRENT_SHAPES, ids=lambda c: c[0])
def test_kernel_at_recurrent_shapes(cuda, case, rows):
    """Per-row quantized operands at each shape, as a forward makes them:
    the kernel equals its plain version bitwise, and with the fused
    per-row scale and GELU within rtol/atol 1e-6."""
    from repro_torch.core.quant import quantize

    _, n, m, act = case
    cfg = BpbsConfig(ba=4, bx=4)
    g = torch.Generator(device=cuda).manual_seed(n + m + rows)
    x = torch.randn(rows, n, generator=g, device=cuda)
    w = torch.randn(n, m, generator=g, device=cuda) * n ** -0.5
    qx = quantize(x, cfg.bx, cfg.coding, per_row=True)
    qw = quantize(w, cfg.ba, cfg.coding, axis=1)
    xs, nu, _ = K.prepare_inputs(qx.q.to(torch.int8), cfg)
    ws, fs = K.prepare_weights(qw.q, cfg)
    y = K.cima_mvm_planes(xs, ws, nu, fs, cfg)
    torch.cuda.synchronize()
    assert torch.equal(y, K.cima_mvm_planes_reference(xs, ws, nu, fs, cfg))
    if act:
        es = (qx.scale * qw.scale.reshape(1, -1)).contiguous()
        y = K.cima_mvm_planes(xs, ws, nu, fs, cfg, es, None, act)
        yr = K.cima_mvm_planes_reference(xs, ws, nu, fs, cfg, es, None, act)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, yr, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["mamba2-130m", "recurrentgemma-9b"])
def test_reduced_recurrent_model_kernel_equals_plain_version(cuda,
                                                             monkeypatch,
                                                             name):
    """Reduced mamba2 (4 SSM layers: 2 launches each) and recurrentgemma
    (rec, rec, attn: 6 + 6 + 7) served on the kernel: launches per
    forward as counted, and greedy tokens equal to the same engine with
    the kernel routed to its plain version on the card."""
    cfg = get_config(name).reduced().with_accel("kernel", ba=4, bx=4)
    per_fwd = {"mamba2-130m": 4 * 2 + 1, "recurrentgemma-9b": 20}[name]
    engine = Engine(init_params(cfg, 0, device=cuda), cfg,
                    ServeConfig(max_seq=32, max_new_tokens=6), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 8), generator=g, device=cuda)
    before = K.cima_mvm_planes.launches
    got = engine.generate(toks)
    assert K.cima_mvm_planes.launches - before == per_fwd * 6
    monkeypatch.setattr(K, "cima_mvm_planes", K.cima_mvm_planes_reference)
    np.testing.assert_array_equal(got, engine.generate(toks))


@pytest.mark.parametrize("net", [NETWORK_A, NETWORK_B], ids=lambda n: n.name)
def test_reduced_cifar_forward_on_the_card(cuda, monkeypatch, net):
    """cnn_forward on the kernel: 9 launches a forward, and logits bitwise
    equal to the same forward on the kernel's plain version on the card
    (every layer's epilogue is relu, sign or identity: exact)."""
    net = net.reduced()
    params = init_cnn(0, net, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    images = torch.randn(8, 32, 32, 3, generator=g, device=cuda)
    before = K.cima_mvm_planes.launches
    logits = cnn_forward(params, images, net)
    torch.cuda.synchronize()
    assert K.cima_mvm_planes.launches - before == 9
    monkeypatch.setattr(K, "cima_mvm_planes", K.cima_mvm_planes_reference)
    plain = cnn_forward(params, images, net)
    assert torch.equal(logits, plain)


def test_sqnr_point_on_the_card_equals_the_cpu(cuda):
    """``sweep_fig7`` draws its operands on the card by default, and a
    Fig. 7 point measured there equals the same operands on the CPU: the
    BP/BS + ADC pipeline on integer grids is exact in float32, so only
    ``sqnr_db``'s float32 means (another summation order) may differ."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x, w = sqnr.random_operands(g, 64, 2304, 64, 4, 2, "and", sparsity=0.3)
    assert x.device.type == w.device.type == "cuda"
    on_card = sqnr.measure_sqnr(None, 2304, 4, 2, "and", operands=(x, w))
    on_cpu = sqnr.measure_sqnr(None, 2304, 4, 2, "and",
                               operands=(x.cpu(), w.cpu()))
    assert on_card == pytest.approx(on_cpu, rel=1e-5)
    assert on_card < 60                       # N = 2304 overflows the ADC
    point, = sqnr.sweep_fig7(n_values=(255,), ba_values=(2,),
                             bx_values=(2,), codings=("and",))
    assert point.sqnr_db > 200                # N = 255 is bit-true


def test_wrapper_rejects_a_cpu_operand_beside_cuda_ones(cuda):
    xs, ws, nu, fs, cfg = _planes(CASES[0], None, cuda)
    with pytest.raises(ValueError, match="nu is on cpu"):
        K.cima_mvm_planes(xs, ws, nu.cpu(), fs, cfg)


def test_reduced_model_kernel_equals_plain_path(cuda):
    cfg = get_config("olmo-1b").reduced().with_accel("kernel", ba=4, bx=4)
    engine = Engine(init_params(cfg, 0, device=cuda), cfg,
                    ServeConfig(max_seq=32, max_new_tokens=6), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 8), generator=g, device=cuda)
    before = K.cima_mvm_planes.launches
    got = engine.generate(toks)
    # 4 layers x 7 projections + unembed, for 1 prefill + 5 decode steps
    assert K.cima_mvm_planes.launches - before == 29 * 6
    logits, _ = engine.prefill(toks)
    with accel.override(backend="bpbs"):
        plain_logits, _ = engine.prefill(toks)
        plain = engine.generate(toks)
    assert K.cima_mvm_planes.launches - before == 29 * 7
    torch.testing.assert_close(logits, plain_logits, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("act", [None, "relu", "silu"])
def test_ste_gradients_kernel_equal_plain_version(cuda, monkeypatch, act):
    """The straight-through ``accel.matmul`` on the kernel backend: one
    launch in the forward, none in the backward, and output and gradients
    (x, w and the epilogue registers) bitwise equal to the same call with
    the kernel routed to its plain version on the card."""
    spec = accel.ExecSpec(backend="kernel", ba=4, bx=4)
    g = torch.Generator(device=cuda).manual_seed(7)
    x0 = torch.randn(64, 2400, generator=g, device=cuda)
    w0 = torch.randn(2400, 96, generator=g, device=cuda) * 0.02
    s0 = torch.rand(96, generator=g, device=cuda) + 0.5
    b0 = torch.randn(96, generator=g, device=cuda)
    up = torch.randn(64, 96, generator=g, device=cuda)

    def run():
        ts = [t.clone().requires_grad_() for t in (x0, w0, s0, b0)]
        post = (accel.Postreduce(scale=ts[2], bias=ts[3], act=act,
                                 saturate=True) if act else None)
        launches = lambda: getattr(K.cima_mvm_planes, "launches", 0)  # noqa
        before = launches()
        y = accel.matmul(ts[0], ts[1], spec, post=post)
        torch.cuda.synchronize()
        fwd = launches() - before
        (y * up).sum().backward()
        torch.cuda.synchronize()
        bwd = launches() - before - fwd
        return y.detach(), [t.grad for t in ts[:4 if act else 2]], fwd, bwd

    y, grads, fwd, bwd = run()
    assert (fwd, bwd) == (1, 0)
    monkeypatch.setattr(K, "cima_mvm_planes", K.cima_mvm_planes_reference)
    y_plain, grads_plain, _, _ = run()
    assert torch.equal(y, y_plain)
    for a, b in zip(grads, grads_plain):
        assert torch.equal(a, b)


def test_full_width_qat_step_on_the_card(cuda, monkeypatch):
    """One QAT step of full-width Network B on 16 images: 9 launches, all
    in the forward, and parameters, running statistics and loss bitwise
    equal to the same step on the kernel's plain version."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.cifar_qat import qat_update
    from repro_torch.tree import leaves

    batch = make_batch(DataConfig(kind="cifar_synthetic", global_batch=16,
                                  seed=1), 0, cuda)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=5, weight_decay=0.0)

    def step():
        params = init_cnn(0, NETWORK_B, device=cuda)
        return qat_update(params, init_opt_state(params), batch, NETWORK_B,
                          opt_cfg)

    before = K.cima_mvm_planes.launches
    params, _, m = step()
    torch.cuda.synchronize()
    assert K.cima_mvm_planes.launches - before == 9
    monkeypatch.setattr(K, "cima_mvm_planes", K.cima_mvm_planes_reference)
    plain, _, pm = step()
    assert float(m["loss"]) == float(pm["loss"])
    for a, b in zip(leaves(params), leaves(plain)):
        assert torch.equal(a, b)


def _noisy_bpbs(cuda, seed, rows=2048):
    """``bpbs`` at sigma 0.3 over one bank of 255 rows (fs = 255): the
    clean output, the output of a noisy dispatch, and the integer-domain
    scale of ``y``."""
    from repro_torch.core.quant import quantize

    r = np.random.default_rng(0)
    x = torch.tensor(r.normal(size=(rows, 255)), dtype=torch.float32,
                     device=cuda)
    w = torch.tensor(r.normal(size=(255, 128)), dtype=torch.float32,
                     device=cuda)
    spec = accel.ExecSpec(backend="bpbs", ba=4, bx=4, bank_n=255,
                          adc_sigma_lsb=0.3)
    clean = accel.matmul(x, w, accel.ExecSpec(backend="bpbs", ba=4, bx=4,
                                              bank_n=255))
    with accel.adc_noise(seed):
        noisy = accel.matmul(x, w, spec)
    scale = quantize(x, 4, Coding.XNOR).scale * quantize(
        w, 4, Coding.XNOR, axis=1).scale.reshape(1, -1)
    return clean, noisy, scale


def test_bpbs_noise_on_the_card_is_deterministic_in_the_seed(cuda):
    """The same seed draws the same noise on the card, bit for bit; another
    seed draws other noise; the noisy path launches no kernel."""
    before = K.cima_mvm_planes.launches
    _, a, _ = _noisy_bpbs(cuda, 3)
    _, b, _ = _noisy_bpbs(cuda, 3)
    _, c, _ = _noisy_bpbs(cuda, 4)
    assert a.device.type == "cuda"
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert K.cima_mvm_planes.launches == before


def test_bpbs_noise_variance_on_the_card_matches_analytic(cuda):
    """At fs = 255 a code moves by e = round(0.3 z), Var(e) =
    P(e = +-1) = erfc(0.5 / (0.3 sqrt 2)) = 0.09558; the error of ``y`` in
    the integer domain has variance 4 Var(e) sum wx^2 sum wa^2 (one bank):
    within 5% over 2048 x 128 outputs (about 12 standard errors)."""
    import math

    from repro_torch.core.quant import plane_weights

    clean, noisy, scale = _noisy_bpbs(cuda, 7)
    err = (noisy - clean) / scale
    var_e = math.erfc(0.5 / 0.3 / math.sqrt(2.0))
    pred = 4.0 * var_e * float(np.sum(plane_weights(4, Coding.XNOR) ** 2)) ** 2
    assert abs(float(torch.mean(err ** 2)) / pred - 1.0) < 0.05


def test_figure_checks_pass_on_the_card(cuda, capsys):
    """``repro_torch.figures.run`` on the card: every paper assertion of
    Figs. 7, 8, 10 and 11 holds."""
    from repro_torch.figures import run as figures_run

    assert figures_run.run_all("cuda") == []
    rows = capsys.readouterr().out.splitlines()
    assert len(rows) == 1 + 17 + 9 + 5 + 57


FA_CASES = [
    # (b, h, hkv, sq, sk, d, causal, window, dtype): tests/test_kernels.py's
    # FA_CASES, its long-window case, a windowed-MQA shape at
    # recurrentgemma's head dim, and top-left alignment with sq != sk
    (2, 4, 2, 256, 256, 64, True, None, torch.float32),
    (1, 2, 2, 128, 128, 32, False, None, torch.float32),
    (1, 4, 1, 256, 256, 64, True, 96, torch.float32),
    (1, 8, 4, 192, 192, 48, True, None, torch.float32),
    (2, 2, 2, 256, 256, 128, True, None, torch.bfloat16),
    (1, 6, 6, 128, 128, 96, True, None, torch.float32),
    (1, 2, 2, 128, 128, 64, True, 4096, torch.float32),
    (1, 4, 1, 300, 300, 256, True, 70, torch.bfloat16),
    (1, 4, 2, 64, 128, 32, False, 40, torch.float32),
    # bf16 on the tensor cores: Sq not a multiple of the 64-row q tile, a
    # zero-filled head-dim bucket (D = 80 in 128), GQA with a window, a
    # non-causal 32-key-tile case at D = 256 with sq != sk, and D = 100
    # (rows not in 16-byte chunks: element copies)
    (1, 4, 2, 200, 200, 80, True, None, torch.bfloat16),
    (2, 8, 2, 257, 257, 64, True, 100, torch.bfloat16),
    (1, 4, 4, 96, 192, 256, False, 50, torch.bfloat16),
    (1, 2, 1, 130, 130, 100, True, None, torch.bfloat16),
]


@pytest.mark.parametrize("case", FA_CASES)
def test_flash_kernel_equals_plain_version(cuda, case):
    b, h, hkv, sq, sk, d, causal, window, dtype = case
    g = torch.Generator(device=cuda).manual_seed(sq + d)
    q = torch.randn(b, h, sq, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, hkv, sk, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, hkv, sk, d, generator=g, device=cuda).to(dtype)
    before = FA.flash_attention.launches
    o = FA.flash_attention(q, k, v, causal=causal, window=window,
                           block_q=64, block_k=64)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert o.dtype == dtype and o.shape == q.shape
    ref = FA.flash_attention_reference(q, k, v, causal, window)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(o.float(), ref.float(), atol=1e-5,
                                   rtol=2 ** -7)
        assert float((o.float() - ref.float()).abs().max()) <= 2e-2
    else:
        torch.testing.assert_close(o, ref, atol=2e-5, rtol=0)


def test_flash_wrapper_rejects_a_cpu_operand_beside_cuda_ones(cuda):
    q = torch.randn(1, 2, 64, 32, device=cuda)
    with pytest.raises(ValueError, match="k is on cpu"):
        FA.flash_attention(q, q.cpu(), q)


def test_reduced_batcher_on_the_card_equals_solo_generate(cuda):
    cfg = get_config("olmo-1b").reduced().with_accel("kernel", ba=4, bx=4)
    scfg = ServeConfig(max_seq=48, max_new_tokens=6)
    cb = ContinuousBatcher(init_params(cfg, 0, device=cuda), cfg, scfg, 2,
                           device=cuda)
    r = np.random.default_rng(1)
    prompts = [r.integers(1, cfg.vocab, (n,)) for n in (3, 9, 5, 13)]
    rids = [cb.submit(p) for p in prompts]
    before = K.cima_mvm_planes.launches
    got = cb.run()
    forwards = cb.stats["decode_steps"] + cb.stats["prefills"]
    assert K.cima_mvm_planes.launches - before == 29 * forwards
    for rid, p in zip(rids, prompts):
        solo = cb.engine.generate(torch.as_tensor(p[None], device=cuda),
                                  request_ids=[rid])[0].tolist()
        assert got[rid] == solo


# ---------------------------------------------------------- paged serving

def _paged_olmo(cuda, **kw):
    """Reduced olmo-1b on the kernel, seed-0 weights, six ragged requests
    with ragged budgets: the slot batcher's streams and a PagedScheduler
    built with ``kw`` (run left to the caller)."""
    cfg = get_config("olmo-1b").reduced().with_accel("kernel", ba=4, bx=4)
    scfg = ServeConfig(max_seq=48, max_new_tokens=12, kv_block_size=8)
    params = init_params(cfg, 0, device=cuda)
    r = np.random.default_rng(3)
    reqs = [(r.integers(1, cfg.vocab, (n,)), m)
            for n, m in zip((3, 9, 5, 13, 7, 4), (12, 2, 9, 5, 12, 3))]
    cb = ContinuousBatcher(params, cfg, scfg, 3, device=cuda)
    for p, m in reqs:
        cb.submit(p, max_new_tokens=m)
    want = cb.run()
    ps = PagedScheduler(params, cfg, scfg, 3, device=cuda, **kw)
    for k, (p, m) in enumerate(reqs):
        ps.submit(p, max_new_tokens=m, priority=k)
    return ps, want


@pytest.mark.parametrize("num_blocks", [None, 3])
def test_reduced_paged_scheduler_on_the_card_equals_the_batcher(cuda,
                                                                num_blocks):
    """Streams equal the slot batcher's on the kernel, at full residency
    and in an oversubscribed pool (deferral and preemption); 29 launches
    a forward, every prefill chunk and decode step one forward."""
    ps, want = _paged_olmo(cuda, num_blocks=num_blocks)
    before = K.cima_mvm_planes.launches
    got = ps.run()
    st = ps.stats
    assert got == want
    assert K.cima_mvm_planes.launches - before == 29 * (
        st["decode_steps"] + st["prefill_chunks"])
    assert st["decode_steps"] == 8 * st["decode_blocks"]
    if num_blocks:
        assert st["deferred_admissions"] > 0 and st["preemptions"] > 0


def test_paged_decode_block_makes_no_host_sync(cuda):
    """Nothing in a block's gather, K decode steps and scatter
    synchronises with the host: under sync debug mode "error" any
    synchronising call would raise."""
    ps, want = _paged_olmo(cuda)
    block, blocks = ps._run_block, []

    def strict(*args):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = block(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        blocks.append(out.shape)
        return out

    ps._run_block = strict
    assert ps.run() == want
    assert len(blocks) == ps.stats["decode_blocks"] > 0


def test_paged_zero_block_stays_zero_after_retirements(cuda):
    """Retired rows keep decoding to the end of their block with sentinel
    tables: their writes go to the discard block, and the zero-read block
    the sentinel gathers from is still all zero after the run."""
    ps, want = _paged_olmo(cuda)
    assert ps.run() == want
    lay = ps.layout
    pools = tree.leaves(ps.paged.pools)
    paged = [(p, b) for p, b, q in zip(pools, lay.batch_axes, lay.seq_axes)
             if q is not None]
    assert paged
    for pool, b_ax in paged:
        assert not pool.narrow(b_ax, lay.sentinel, 1).any()
        assert pool.narrow(b_ax, lay.sentinel + 1, 1).any()


# --------------------------------------------------------- grouped launch

def _grouped_planes(groups, rows, n, m, device, seed=0):
    """Per-row quantized operands of ``groups`` experts, as a MoE layer
    makes them (the middle group all zero: an expert no token reached),
    as grouped planes."""
    from repro_torch.core.quant import quantize

    cfg = BpbsConfig(ba=4, bx=4)
    g = torch.Generator(device=device).manual_seed(seed + groups + rows)
    x = torch.randn(groups, rows, n, generator=g, device=device)
    if groups > 1:
        x[groups // 2] = 0.0
    w = torch.randn(groups, n, m, generator=g, device=device) * n ** -0.5
    qx = quantize(x, cfg.bx, cfg.coding, per_row=True)
    qw = torch.stack([quantize(wi, cfg.ba, cfg.coding, axis=1).q for wi in w])
    xs, nu, _ = K.prepare_inputs(qx.q.to(torch.int8), cfg, grouped=True)
    ws, fs = K.prepare_weights(qw, cfg)
    return xs, ws, nu, fs, cfg


@pytest.mark.parametrize("cluster", [None, 1, 2, 4])
@pytest.mark.parametrize("rows", [1, 5, 15])
@pytest.mark.parametrize("groups", [1, 8, 64])
def test_grouped_launch_equals_plain_version(cuda, monkeypatch, groups, rows,
                                             cluster):
    """One grouped launch (the experts on gridDim.z) over a ragged last
    bank (2,400 rows) and a partial column tile (M = 144): bitwise equal
    to the grouped plain version and, group by group, to the 2-D launch
    on that group's operands, at every cluster size; with the fused SiLU
    and per-group per-row scales within rtol/atol 1e-6 of the plain
    version and bitwise to each group's 2-D launch."""
    xs, ws, nu, fs, cfg = _grouped_planes(groups, rows, 2400, 144, cuda)
    _force_cluster(monkeypatch, cluster)
    before = K.cima_mvm_planes.launches
    y = K.cima_mvm_planes(xs, ws, nu, fs, cfg)
    torch.cuda.synchronize()
    assert K.cima_mvm_planes.launches == before + 1
    assert tuple(y.shape) == (groups, rows, 144)
    assert torch.equal(y, K.cima_mvm_planes_reference(xs, ws, nu, fs, cfg))
    g = torch.Generator(device=cuda).manual_seed(7)
    es = torch.rand(groups, rows, 144, generator=g, device=cuda) * 1e-3
    pb = torch.randn(144, generator=g, device=cuda)
    yf = K.cima_mvm_planes(xs, ws, nu, fs, cfg, es, pb, "silu")
    yr = K.cima_mvm_planes_reference(xs, ws, nu, fs, cfg, es, pb, "silu")
    torch.cuda.synchronize()
    torch.testing.assert_close(yf, yr, rtol=1e-6, atol=1e-6)
    for i in sorted({0, groups // 2, groups - 1}):
        assert torch.equal(y[i], K.cima_mvm_planes(xs[i], ws[i], nu[i], fs,
                                                   cfg))
        assert torch.equal(yf[i], K.cima_mvm_planes(
            xs[i], ws[i], nu[i], fs, cfg, es[i], pb, "silu"))


@pytest.mark.parametrize("rows", [1, 15])
@pytest.mark.parametrize("shape", [(2048, 1408, "silu"), (1408, 2048, None)],
                         ids=["gate", "down"])
def test_grouped_launch_at_deepseek_expert_shapes(cuda, shape, rows):
    """deepseek-v2-lite's 64 routed experts at decode (capacity 1) and
    at a 128-token prefill (capacity 15): bitwise, and fused within
    rtol/atol 1e-6."""
    n, m, act = shape
    xs, ws, nu, fs, cfg = _grouped_planes(64, rows, n, m, cuda)
    y = K.cima_mvm_planes(xs, ws, nu, fs, cfg)
    torch.cuda.synchronize()
    assert torch.equal(y, K.cima_mvm_planes_reference(xs, ws, nu, fs, cfg))
    if act:
        es = torch.full((64, 1, m), 1e-3, device=cuda)
        y = K.cima_mvm_planes(xs, ws, nu, fs, cfg, es, None, act)
        yr = K.cima_mvm_planes_reference(xs, ws, nu, fs, cfg, es, None, act)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, yr, rtol=1e-6, atol=1e-6)


def test_grouped_launch_rejects_mismatched_groups(cuda):
    xs, ws, nu, fs, cfg = _grouped_planes(4, 2, 256, 64, cuda)
    before = K.cima_mvm_planes.launches
    for bad in (dict(ws=ws[:3].contiguous()), dict(nu=nu[:2].contiguous()),
                dict(ws=ws[0])):
        args = {**dict(xs=xs, ws=ws, nu=nu, fs=fs, cfg=cfg), **bad}
        with pytest.raises(ValueError):
            K.cima_mvm_planes(**args)
    with pytest.raises(ValueError, match="epilogue operand"):
        K.cima_mvm_planes(xs, ws, nu, fs, cfg, torch.ones(3, 1, 64,
                                                          device=cuda))
    assert K.cima_mvm_planes.launches == before


def test_reduced_deepseek_kernel_equals_plain_version(cuda, monkeypatch):
    """Reduced deepseek-v2-lite (a dense MLA layer: 8 launches; three MoE
    layers: 5 MLA + 3 grouped expert + 3 shared-expert launches each; the
    unembed) served on the kernel: 42 launches a forward, and greedy
    tokens equal to the same engine with the kernel routed to its plain
    version on the card."""
    cfg = get_config("deepseek-v2-lite-16b").reduced().with_accel(
        "kernel", ba=4, bx=4)
    engine = Engine(init_params(cfg, 0, device=cuda), cfg,
                    ServeConfig(max_seq=32, max_new_tokens=6), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 8), generator=g, device=cuda)
    before = K.cima_mvm_planes.launches
    got = engine.generate(toks)
    assert K.cima_mvm_planes.launches - before == (8 + 3 * 11 + 1) * 6
    monkeypatch.setattr(K, "cima_mvm_planes", K.cima_mvm_planes_reference)
    np.testing.assert_array_equal(got, engine.generate(toks))


@pytest.mark.parametrize("post", [None, "silu"])
@pytest.mark.parametrize("rows", [1, 15])
@pytest.mark.parametrize("shape", [(2048, 1408), (1408, 2048)],
                         ids=["gate", "down"])
def test_grouped_forward_under_autograd_equals_plain_version(
        cuda, monkeypatch, shape, rows, post):
    """The grouped straight-through ``accel.matmul`` at deepseek's 64
    routed experts: one grouped launch in the forward, none in the
    backward; output and gradients of x, w (and the shared epilogue's
    scale and bias) bitwise equal to the same call with the kernel routed
    to its plain version on the card."""
    n, m = shape
    spec = accel.ExecSpec(backend="kernel", ba=4, bx=4)
    g = torch.Generator(device=cuda).manual_seed(3)
    x0 = torch.randn(64, rows, n, generator=g, device=cuda)
    w0 = torch.randn(64, n, m, generator=g, device=cuda) * n ** -0.5
    s0 = torch.rand(m, generator=g, device=cuda) + 0.5
    b0 = torch.randn(m, generator=g, device=cuda)
    up = torch.randn(64, rows, m, generator=g, device=cuda)

    def run():
        ts = [t.clone().requires_grad_() for t in (x0, w0, s0, b0)]
        epi = (accel.Postreduce(scale=ts[2], bias=ts[3], act=post)
               if post else None)
        launches = lambda: getattr(K.cima_mvm_planes, "launches", 0)  # noqa
        before = launches()
        y = accel.matmul(ts[0], ts[1], spec, post=epi)
        torch.cuda.synchronize()
        fwd = launches() - before
        (y * up).sum().backward()
        torch.cuda.synchronize()
        bwd = launches() - before - fwd
        return y.detach(), [t.grad for t in ts[:4 if post else 2]], fwd, bwd

    y, grads, fwd, bwd = run()
    assert (fwd, bwd) == (1, 0)
    monkeypatch.setattr(K, "cima_mvm_planes", K.cima_mvm_planes_reference)
    y_plain, grads_plain, _, _ = run()
    assert torch.equal(y, y_plain)
    for a, b in zip(grads, grads_plain):
        assert torch.equal(a, b)


def test_sqnr_quality_on_the_kernel_equals_the_plain_route(cuda, monkeypatch):
    """The tuner's SQNR probes (32 rows x N <= 2,304 x M = 64) on the
    kernel backend: the same scores as with the kernel routed to its
    plain version on the card, one launch a probe."""
    from repro_torch import tune

    policy = accel.PrecisionPolicy.uniform(
        accel.ExecSpec(backend="kernel", ba=4, bx=4))
    fps = [accel.ImageFootprint(path=f"p{n}", tag=f"t{n}", kind="mlp", n=n,
                                m=64) for n in (128, 2048, 2304, 8192)]
    holder = type("CostModel", (), {"footprints": fps})
    scores = {}
    for route in ("kernel", "plain"):
        if route == "plain":
            monkeypatch.setattr(K, "cima_mvm_planes",
                                K.cima_mvm_planes_reference)
        for ba in (1, 4, 8):
            cand = tune.Candidate(policy=tune.space._rescale_policy(
                policy, ba, ba))
            before = getattr(K.cima_mvm_planes, "launches", 0)
            scores[route, ba] = tune.SqnrQuality().score(cand, holder)
            if route == "kernel":
                assert K.cima_mvm_planes.launches - before == 3
    for ba in (1, 4, 8):
        assert np.isfinite(scores["kernel", ba])
        assert scores["kernel", ba] == scores["plain", ba]


# ------------------------------------------- whisper and early fusion

# whisper-tiny's one short bank (N = 384 of bank_n 2,304) with column
# counts off the 16-wide tile by an odd number (its 51,865-word unembed
# and two small ones: the byte-copy weight path, per-element stores), and
# the early-fusion configs' two-bank (3,072) and three-bank (5,120) rows
FRONTEND_SHAPES = [
    ("M17", 384, 17, None), ("M33", 384, 33, "gelu"),
    ("whisper.unembed", 384, 51865, None), ("whisper.up", 384, 1536, "gelu"),
    ("whisper.down", 1536, 384, None), ("phi3v.gate", 3072, 8192, "silu"),
    ("llama4.kv", 5120, 1024, None), ("llama4.down", 8192, 5120, None),
]


@pytest.mark.parametrize("rows", [4, 131])
@pytest.mark.parametrize("case", FRONTEND_SHAPES, ids=lambda c: c[0])
def test_kernel_at_frontend_shapes(cuda, case, rows):
    """Odd column counts and one short bank: bitwise to the plain
    version, and with the fused per-row scale and activation within
    rtol/atol 1e-6 (the recurrent shapes' test at these shapes)."""
    test_kernel_at_recurrent_shapes(cuda, case, rows)


def test_grouped_cross_kv_launch_equals_2d_launches(cuda):
    """whisper's cross k/v as one grouped launch over its 4 decoder
    layers, the encoder output (4 x 1,500 rows) shared by every group:
    bitwise to the grouped plain version and to each layer's own 2-D
    launch."""
    from repro_torch.core.quant import quantize

    cfg = BpbsConfig(ba=4, bx=4)
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(6000, 384, generator=g, device=cuda).expand(4, 6000, 384)
    w = torch.randn(4, 384, 384, generator=g, device=cuda) * 384 ** -0.5
    qx = quantize(x, cfg.bx, cfg.coding, per_row=True)
    qw = torch.stack([quantize(wi, cfg.ba, cfg.coding, axis=1).q for wi in w])
    xs, nu, _ = K.prepare_inputs(qx.q.to(torch.int8), cfg, grouped=True)
    ws, fs = K.prepare_weights(qw, cfg)
    y = K.cima_mvm_planes(xs, ws, nu, fs, cfg)
    torch.cuda.synchronize()
    assert torch.equal(y, K.cima_mvm_planes_reference(xs, ws, nu, fs, cfg))
    for i in range(4):
        assert torch.equal(y[i], K.cima_mvm_planes(xs[i], ws[i], nu[i], fs,
                                                   cfg))


def test_reduced_whisper_cross_kv_is_one_grouped_launch(cuda):
    """Through the model: ``_cross_kv_all_layers`` on reduced whisper is
    two grouped launches (k and v over the 4 layers), bitwise to
    ``encode_cross_kv`` of each layer on its own (8 launches)."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import model as model_mod
    from repro_torch.models.transformer import layer_slice

    cfg = get_config("whisper-tiny").reduced().with_accel(
        "kernel", ba=4, bx=4, x_per_row=True)
    params = init_params(cfg, 0, device=cuda)
    params = accel.install_program(params, accel.build_program(params, cfg),
                                   cfg)
    g = torch.Generator(device=cuda).manual_seed(2)
    enc = torch.randn(2, cfg.frontend_seq, cfg.d_model, generator=g,
                      device=cuda)
    with torch.inference_mode():
        before = K.cima_mvm_planes.launches
        k, v = model_mod._cross_kv_all_layers(params, enc, cfg,
                                              torch.float32)
        assert K.cima_mvm_planes.launches - before == 2
        for i in range(cfg.n_layers):
            ki, vi = attn_mod.encode_cross_kv(
                layer_slice(params["cross"], i)["attn"], enc, cfg,
                torch.float32)
            assert torch.equal(k[i], ki) and torch.equal(v[i], vi)


@pytest.mark.parametrize("name", ["whisper-tiny", "phi-3-vision-4.2b",
                                  "llama4-scout-17b-a16e"])
def test_frontend_model_kernel_equals_plain_version(cuda, monkeypatch, name):
    """whisper-tiny at published widths (4 + 4 layers, 1,500 frames: 59
    launches a prefill, 33 a decode step) and reduced phi-3-vision (4
    layers: 7 a layer and the lm_head) and llama4-scout (4 MoE layers:
    10 a layer, 3 of them grouped, and the lm_head) with seeded frontend
    embeddings, served on the kernel: launches as counted, and greedy
    tokens equal to the same engine with the kernel routed to its plain
    version on the card."""
    cfg = get_config(name)
    if name != "whisper-tiny":
        cfg = cfg.reduced()
    cfg = cfg.with_accel("kernel", ba=4, bx=4)
    prefill_n, decode_n = {"whisper-tiny": (59, 33),
                           "phi-3-vision-4.2b": (29, 29),
                           "llama4-scout-17b-a16e": (41, 41)}[name]
    engine = Engine(init_params(cfg, 0, device=cuda, max_seq=64), cfg,
                    ServeConfig(max_seq=32, max_new_tokens=4), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, cfg.frontend_seq + 4)
                         if cfg.frontend != "audio" else (2, 8),
                         generator=g, device=cuda)
    fe = 0.1 * torch.randn(2, cfg.frontend_seq, cfg.d_model, generator=g,
                           device=cuda)
    before = K.cima_mvm_planes.launches
    got = engine.generate(toks, frontend_embeds=fe)
    assert K.cima_mvm_planes.launches - before == prefill_n + 3 * decode_n
    monkeypatch.setattr(K, "cima_mvm_planes", K.cima_mvm_planes_reference)
    np.testing.assert_array_equal(got, engine.generate(toks,
                                                       frontend_embeds=fe))


# ------------------------------------------------------ per-device tiles

@pytest.mark.parametrize("rows", [4, 128])
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("part", ["col", "row"])
def test_tile_launch_equals_plain_version(cuda, part, shards, rows):
    """One rank's tile of olmo-1b's mlp.up (2,048 x 8,192 cut along M) or
    mlp.down's transpose (cut along N): the kernel on the tile is bitwise
    its plain version; the column tiles side by side are the whole
    launch, and at bank_n = 256 (whole banks per tile) the row tiles'
    integer partials sum to it."""
    from repro_torch.core.quant import quantize

    cfg = BpbsConfig(ba=4, bx=4, bank_n=256)
    g = torch.Generator(device="cuda").manual_seed(shards * 1000 + rows)
    x = torch.randn(rows, 2048, generator=g, device="cuda")
    w = torch.randn(2048, 8192, generator=g, device="cuda") * 2048 ** -0.5
    if part == "row":
        x = torch.randn(rows, 8192, generator=g, device="cuda")
        w = w.T.contiguous()
    qx = quantize(x, 4, Coding.XNOR, per_row=True).q.to(torch.int8)
    qw = quantize(w, 4, Coding.XNOR, axis=1).q
    whole = K.cima_mvm(qx, qw, cfg)
    n, m = qw.shape
    outs = []
    for k in range(shards):
        if part == "col":
            xq, wq = qx, qw[:, k * m // shards:(k + 1) * m // shards]
        else:
            lo, hi = k * n // shards, (k + 1) * n // shards
            xq, wq = qx[:, lo:hi], qw[lo:hi]
        xs, nu, _ = K.prepare_inputs(xq, cfg)
        ws, fs = K.prepare_weights(wq, cfg)
        y = K.cima_mvm_planes(xs, ws, nu, fs, cfg)
        assert torch.equal(y, K.cima_mvm_planes_reference(xs, ws, nu, fs,
                                                          cfg))
        outs.append(y)
    if part == "col":
        assert torch.equal(torch.cat(outs, dim=-1), whole)
    else:
        assert torch.equal(sum(outs), whole)


def test_sharded_engine_on_the_card_equals_unsharded(cuda, tmp_path):
    """Two gloo ranks sharing the card serve reduced olmo-1b on a 1 x 2
    mesh through the kernel: tokens, logits (bank_n = 16: whole banks per
    tile) and both batchers' streams equal the unsharded engine's."""
    import torch_mesh as tm

    cfg = get_config("olmo-1b").reduced().with_accel("kernel", ba=4, bx=4,
                                                     bank_n=16)
    params = init_params(cfg, 0, device="cpu", max_seq=64)
    r = np.random.default_rng(0)
    prompts = r.integers(0, cfg.vocab, (4, 8))
    requests = [(r.integers(0, cfg.vocab, (n,)), m)
                for n, m in zip((5, 9, 3, 12, 7), (4, 6, 2, 5, 3))]
    serve = dict(max_seq=32, max_new_tokens=6, kv_block_size=8,
                 decode_block=4)
    ranks = tm.spawn("serve", 2, tmp_path, dict(
        configs={"olmo-1b": (cfg, params)}, meshes={"olmo-1b": [(1, 2)]},
        prompts=prompts, requests=requests, serve=serve, n_slots=4,
        tuned_config="olmo-1b", device="cuda"))
    flat = tm.serve_all(params, cfg, ServeConfig(**serve), prompts,
                        requests, 4, device="cuda")
    for res in ranks:
        got = res[((1, 2), "olmo-1b")]
        np.testing.assert_array_equal(got["tokens"], flat["tokens"])
        for key in ("logits", "logits_digital_int"):
            assert torch.equal(got[key], flat[key]), key
        assert got["batcher"] == flat["batcher"]
        assert got["paged"] == flat["paged"]


def test_global_batch_input_scale_on_the_card(cuda, tmp_path):
    """Two gloo ranks sharing the card each quantize their rows of one
    input inside ``global_batch`` (a training step on a mesh): grid and
    scale are the whole input's on the card, one collective each (the
    amax bitwise; the XNOR 1-bit mean, a sum over the global count,
    within 1e-6), where a rank's own statistic differs."""
    import torch_mesh as tm
    from repro_torch.accel.backends import quantize_input

    r = np.random.default_rng(0)
    x = (r.normal(size=(8, 64)) * np.arange(1, 9)[:, None]).astype(
        np.float32)
    grids = [(Coding.XNOR, 4), (Coding.AND, 4), (Coding.XNOR, 8),
             (Coding.XNOR, 1)]
    ranks = tm.spawn("quant", 2, tmp_path, dict(x=x, grids=grids,
                                                device="cuda"))
    xt = torch.from_numpy(x).to(cuda)
    for coding, bx in grids:
        spec = accel.ExecSpec(backend="bpbs", bx=bx, coding=coding)
        whole = quantize_input(xt, spec)
        for k, res in enumerate(ranks):
            q, scale, collectives = res[(coding, bx)]
            assert torch.equal(q, whole.q[4 * k:4 * k + 4]), (coding, bx)
            if coding == Coding.XNOR and bx == 1:
                torch.testing.assert_close(scale, whole.scale, rtol=1e-6,
                                           atol=0)
            else:
                assert torch.equal(scale, whole.scale), (coding, bx)
            assert collectives == 1
        assert not torch.equal(quantize_input(xt[:4], spec).scale,
                               whole.scale)


def test_mesh_train_step_on_the_card_matches_unsharded(cuda, tmp_path):
    """Two gloo ranks sharing the card train reduced olmo-1b on the
    kernel on a 1 x 2 mesh in mode "fsdp" (each rank half the rows, the
    state ZeRO-3): each rank's logits on its rows bitwise the unsharded
    kernel route's, step 1's loss within 1e-6 and step 2's within 5e-3
    of the unsharded steps'."""
    import torch_mesh as tm
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import forward
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import build_train_step, init_train_state

    cfg = get_config("olmo-1b").reduced().with_accel("kernel", ba=4, bx=4)
    params = init_params(cfg, 0, device="cpu")
    data = DataConfig(seq_len=16, global_batch=4, vocab=cfg.vocab, seed=0)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    case = ((1, 2), "fsdp", "olmo-1b", 2, None)
    ranks = tm.spawn("train", 2, tmp_path, dict(
        configs={"olmo-1b": (cfg, params)}, cases=[case], data=data,
        opt=opt, device="cuda"))
    p = tree.tree_map(lambda t: t.to(cuda), params)
    with torch.no_grad():
        logits = forward(p, make_batch(data, 0, "cuda")["tokens"], cfg)[0]
    state, step, losses = init_train_state(p), build_train_step(cfg, opt), []
    for s in range(2):
        state, m = step(state, make_batch(data, s, "cuda"))
        losses.append(float(m["loss"]))
    for res in ranks:
        got = res[case]
        assert torch.equal(got["logits"], logits[got["rows"].to(cuda)])
        np.testing.assert_allclose(got["steps"][0]["loss"], losses[0],
                                   rtol=1e-6)
        np.testing.assert_allclose(got["steps"][1]["loss"], losses[1],
                                   rtol=5e-3)


def test_sanitize_inside_graph_capture(cuda):
    """A digital ``accel.matmul`` captured by ``torch.cuda.graph`` inside
    a ``sanitize()`` scope: the dispatch counts, no check reads the
    capturing stream (none raises, none counts), and the graph replays
    to the eager result's bits."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(8, 64, generator=g, device=cuda)
    w = torch.randn(64, 32, generator=g, device=cuda)
    spec = accel.ExecSpec(backend="digital")
    want = accel.matmul(x, w, spec)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm up off the graph
        accel.matmul(x, w, spec)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with accel.sanitize() as san:
        with torch.cuda.graph(graph):
            y = accel.matmul(x, w, spec)
    assert san.stats.dispatches == 1 and san.stats.finite_checks == 0
    y.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, want)


def test_sanitize_scope_reaches_autograds_thread(cuda):
    """A remat training step of 2-layer olmo-1b on ``bpbs`` under a scope
    counts the same dispatches, checks and ADC codes on the card as on
    the CPU: on CUDA autograd replays the layers in its own thread, and
    the module-wide scope stack still sees them."""
    import dataclasses

    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import build_train_step, init_train_state

    base = dataclasses.replace(get_config("olmo-1b").reduced(), n_layers=2)
    data = DataConfig(seq_len=16, global_batch=2, vocab=base.vocab, seed=0)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    params = init_params(base, 0, device="cpu")
    counts = {}
    for remat, dev in ((False, "cpu"), (True, "cpu"), (True, "cuda")):
        cfg = dataclasses.replace(base, remat=remat).with_accel(
            "bpbs", ba=4, bx=4)
        state = init_train_state(tree.tree_map(lambda t: t.to(dev), params))
        step = build_train_step(cfg, opt)
        with accel.sanitize() as san:
            step(state, make_batch(data, 0, dev))
        s = san.stats
        counts[remat, dev] = (s.dispatches, s.finite_checks,
                              s.adc_conversions)
    assert counts[True, "cuda"] == counts[True, "cpu"]
    # remat's replay is in the count: the layers dispatch twice
    assert counts[True, "cpu"][0] > counts[False, "cpu"][0]
