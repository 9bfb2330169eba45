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
from repro_torch.serve import ContinuousBatcher, Engine, ServeConfig

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
    monkeypatch.setattr(K, "launch_shape", lambda b, n, m, cfg, sms:
                        pick(b, n, m, cfg, sms)[:2] + (cluster,))


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
