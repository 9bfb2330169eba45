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
from repro_torch.configs import get_config
from repro_torch.core.bpbs import BpbsConfig
from repro_torch.core.quant import Coding, int_range
from repro_torch.kernels import cima_mvm as K
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import init_params
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
