"""The port's cima_mvm against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs the kernel's plain torch version; the
JAX side runs ``repro.kernels.ops.cima_mvm`` in interpret mode, as its own
tests do.  Without the fused epilogue every value is an exact small
integer, so the outputs must match bit for bit.  With the epilogue, XLA
on the CPU may contract ``y*escale + pbias`` into one fused multiply-add
and the transcendental activations (silu, tanh-gelu) may round ``exp``/
``tanh`` differently: rtol 1e-6, a few float32 ulps.  The CUDA kernel
itself is held to the plain version on the card by
``tests/test_torch_cuda.py``.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bpbs import BpbsConfig as JCfg
from repro.kernels import ops as jops
from repro_torch.core.bpbs import BpbsConfig as TCfg
from repro_torch.core.quant import Coding, int_range
from repro_torch.kernels import cima_mvm as K
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _ops(coding, ba, bx, n, m, batch, sparsity=0.3, seed=0):
    """Integer-grid operands, as tests/test_kernels.py makes them."""
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
    return x.astype(np.float32), w.astype(np.float32)


CASES = [
    # (coding, ba, bx, n, m, bank_n): the two tier-1 CIMA_CASES of
    # tests/test_kernels.py, then multi-bank ragged cases
    (Coding.XNOR, 4, 4, 300, 40, 2304),
    (Coding.AND, 2, 2, 512, 16, 128),
    (Coding.XNOR, 2, 3, 512, 16, 256),
    (Coding.XNOR, 4, 2, 2400, 24, 2304),
]


def _both(case, variant=None, batch=5):
    coding, ba, bx, n, m, bank_n = case
    x, w = _ops(coding, ba, bx, n, m, batch)
    kw = dict(ba=ba, bx=bx, coding=coding.value, bank_n=bank_n,
              **(variant or {}))
    return x, w, JCfg(**kw), TCfg(**kw)


@pytest.mark.parametrize("variant", [None, {"adaptive_range": True},
                                     {"ideal_adc": True}])
@pytest.mark.parametrize("case", CASES)
def test_cima_mvm_matches_pallas_bitwise(case, variant):
    x, w, jc, tc = _both(case, variant)
    yj = jops.cima_mvm(jnp.asarray(x), jnp.asarray(w), jc, block_b=8,
                       block_m=16)
    yt = tops.cima_mvm(torch.from_numpy(x), torch.from_numpy(w), tc)
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    # and the port's own oracle agrees
    assert torch.equal(yt, tref.cima_mvm_ref(torch.from_numpy(x),
                                             torch.from_numpy(w), tc))


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu", "sign",
                                 "identity"])
def test_cima_mvm_fused_epilogue_matches_pallas(act, per_row):
    x, w, jc, tc = _both(CASES[3])
    r = np.random.default_rng(1)
    m = w.shape[1]
    es = r.uniform(1e-3, 2e-3, (x.shape[0], m) if per_row else (m,))
    es = es.astype(np.float32)
    pb = r.normal(size=m).astype(np.float32)
    yj = jops.cima_mvm(jnp.asarray(x), jnp.asarray(w), jc, block_b=8,
                       block_m=8, escale=jnp.asarray(es),
                       pbias=jnp.asarray(pb), act=act, by_bits=16)
    yt = tops.cima_mvm(torch.from_numpy(x), torch.from_numpy(w), tc,
                       escale=torch.from_numpy(es),
                       pbias=torch.from_numpy(pb), act=act, by_bits=16)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-6,
                               atol=1e-6)


def test_cima_mvm_from_planes_equals_on_the_fly():
    x, w, _, tc = _both(CASES[2])
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    ws, _ = K.prepare_weights(wt, tc)
    assert ws.dtype == torch.int8 and tuple(ws.shape) == (512, 2, 16)
    assert torch.equal(tops.cima_mvm_from_planes(xt, ws, tc),
                       tops.cima_mvm(xt, wt, tc))


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("coding", [Coding.AND, Coding.XNOR])
def test_weight_planes_in_column_blocks_are_the_same_bits(monkeypatch,
                                                          coding, grouped):
    """A weight over PLANE_ELEMENTS is decomposed a block of output columns
    at a time (37 columns here, a ragged last block), a grouped one too:
    the same int8 planes as the whole weight at once."""
    tc = TCfg(ba=4, bx=4, coding=coding)
    lo, hi = int_range(4, coding)
    step = 2 if coding == Coding.XNOR else 1            # the coding's grid
    shape = (3, 64, 100) if grouped else (64, 100)
    w = torch.from_numpy(step * np.random.default_rng(2).integers(
        lo // step, hi // step + 1, shape).astype(np.float32))
    whole, fs = K.prepare_weights(w, tc)
    monkeypatch.setattr(K, "PLANE_ELEMENTS", 37 * w.numel() // 100)
    blocks, fs_b = K.prepare_weights(w, tc)
    assert blocks.dtype == torch.int8 and blocks.is_contiguous()
    assert torch.equal(blocks, whole) and torch.equal(fs_b, fs)


def test_cima_mvm_leading_batch_dims():
    x, w, _, tc = _both(CASES[0], batch=6)
    xt = torch.from_numpy(x).reshape(2, 3, -1)
    y = tops.cima_mvm(xt, torch.from_numpy(w), tc)
    assert tuple(y.shape) == (2, 3, 40)
    assert torch.equal(y.reshape(6, 40),
                       tops.cima_mvm(torch.from_numpy(x), torch.from_numpy(w),
                                     tc))


def test_bank_full_scales_ragged():
    fs = K.bank_full_scales(5000, TCfg(bank_n=2304), "cpu")
    assert fs.tolist() == [2304.0, 2304.0, 392.0]


def _planes(case=CASES[0]):
    x, w, _, tc = _both(case)
    xs, nu, _ = K.prepare_inputs(torch.from_numpy(x), tc)
    ws, fs = K.prepare_weights(torch.from_numpy(w), tc)
    return xs, ws, nu, fs, tc


@pytest.mark.parametrize("bad", ["xs_dtype", "ws_shape", "nu_shape",
                                 "not_contiguous", "bits", "act",
                                 "adc_bits"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    import dataclasses

    xs, ws, nu, fs, tc = _planes()
    act = None
    if bad == "xs_dtype":
        xs = xs.to(torch.int16)
    elif bad == "ws_shape":
        ws = ws[:, :2].contiguous()
    elif bad == "nu_shape":
        nu = nu[:, :0]
    elif bad == "not_contiguous":
        ws = ws.transpose(0, 2).contiguous().transpose(0, 2)
    elif bad == "bits":
        tc = dataclasses.replace(tc, bx=9)
    elif bad == "act":
        act = "tanh"
    else:
        tc = dataclasses.replace(tc, adc_bits=30)
    with pytest.raises(ValueError):
        K._check_launch(xs, ws, nu, fs, tc, act)


def test_wrapper_raises_on_a_device_without_a_kernel():
    """Neither CPU (the plain version) nor CUDA (the kernel) nor meta (a
    dry run's shapes): the wrapper raises.  A stand-in operand names the
    device, as this torch has no other device to put a tensor on."""
    xs, ws, nu, fs, tc = _planes()
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="no kernel"):
        K.cima_mvm_planes(other, ws, nu, fs, tc)
    # meta returns the output's shape and no values
    out = K.cima_mvm_planes(xs.to("meta"), ws.to("meta"), nu.to("meta"),
                            fs.to("meta"), tc)
    assert out.device.type == "meta" and out.dtype == torch.float32
    assert tuple(out.shape) == (xs.shape[0], ws.shape[-1])


def test_cpu_tensors_run_the_plain_version_without_launching():
    xs, ws, nu, fs, tc = _planes()
    before = K.cima_mvm_planes.launches
    y = K.cima_mvm_planes(xs, ws, nu, fs, tc)
    assert K.cima_mvm_planes.launches == before
    assert torch.equal(y, K.cima_mvm_planes_reference(xs, ws, nu, fs, tc))



@pytest.mark.parametrize("b,n,m,ba,bx,want", [
    # (B, N, M, B_A, B_X, (mt, tb, cs)): the main path's projections at
    # decode and prefill on a 132-SM card, then ragged and wide-plane cases
    (4, 2048, 2048, 4, 4, (1, 4, 4)),
    (4, 2048, 8192, 4, 4, (1, 4, 2)),
    (4, 8192, 2048, 4, 4, (1, 4, 4)),
    (4, 2048, 50304, 4, 4, (1, 4, 1)),
    (128, 2048, 2048, 4, 4, (4, 16, 1)),
    (128, 2048, 50304, 4, 4, (4, 16, 1)),
    (1, 300, 40, 4, 4, (1, 4, 2)),
    (5, 300, 40, 4, 3, (1, 5, 2)),
    (6, 300, 40, 4, 3, (2, 10, 2)),
    (33, 100, 8, 8, 8, (1, 2, 1)),
    (9, 700, 12, 2, 2, (2, 16, 4)),
])
def test_launch_shape_fills_the_card(b, n, m, ba, bx, want):
    cfg = TCfg(ba=ba, bx=bx)
    mt, tb, cs = K.launch_shape(b, n, m, cfg, sms=132)
    assert (mt, tb, cs) == want
    # whole batch rows in a tile of 16*mt A rows, and at least two chunks
    # of the largest bank for every block of a cluster
    assert tb * bx <= 16 * mt and tb * bx > 16 * mt - bx
    assert cs == 1 or -(-min(cfg.bank_n, n) // K.CHUNK_ROWS) >= 2 * cs


def test_launch_shape_picks_only_sizes_the_kernel_takes():
    """Over a sweep of shapes the tiling stays within what the C entry
    point accepts: mt in 1, 2, 4 (1 above B_A = 4), whole batch rows in
    the tile, clusters of 1, 2 or 4."""
    for ba, bx in ((1, 1), (4, 4), (3, 5), (8, 8)):
        cfg = TCfg(ba=ba, bx=bx)
        for b in (1, 4, 5, 16, 33, 128):
            for n, m in ((64, 8), (2048, 2048), (8192, 2048),
                         (2048, 50304)):
                for sms in (1, 132):
                    mt, tb, cs = K.launch_shape(b, n, m, cfg, sms)
                    assert mt in (1, 2, 4) and (mt == 1 or ba <= 4)
                    assert 1 <= tb and tb * bx <= 16 * mt
                    assert cs in (1, 2, 4)
                    assert K.launch_shape(b, n, m, cfg, sms) == (mt, tb, cs)
