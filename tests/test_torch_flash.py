"""The port's flash-attention entry point against the JAX package's.

``repro_torch.kernels.ops.flash_attention`` on CPU tensors runs the plain
torch version of the CUDA kernel; the reference runs its Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` runs it.  Inputs are made
with numpy from the same seeds as ``FA_CASES`` there.  Tolerances are the
reference's own: float32 atol 2e-5 (the same f32 arithmetic summed in
another order), bfloat16 atol 2e-2 (one bf16 rounding of the output, and
online against dense softmax).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as F
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

FA_CASES = [
    # (b, h, hkv, s, d, causal, window, bq, bk, dtype): tests/test_kernels.py
    (2, 4, 2, 256, 64, True, None, 64, 64, "float32"),
    (1, 2, 2, 128, 32, False, None, 64, 64, "float32"),
    (1, 4, 1, 256, 64, True, 96, 64, 64, "float32"),     # window + MQA
    (1, 8, 4, 192, 48, True, None, 64, 64, "float32"),   # padded seq + d
    (2, 2, 2, 256, 128, True, None, 128, 128, "bfloat16"),
    (1, 6, 6, 128, 96, True, None, 64, 64, "float32"),   # whisper-ish dims
]
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(seed, b, h, hkv, sq, sk, d):
    r = np.random.default_rng(seed)
    return (r.normal(size=(b, h, sq, d)), r.normal(size=(b, hkv, sk, d)),
            r.normal(size=(b, hkv, sk, d)))


def _both(arrays, dtype):
    """The same numpy arrays as JAX arrays and as CPU torch tensors, both
    rounded once to ``dtype``."""
    js = [jnp.asarray(a, JDT[dtype]) for a in arrays]
    ts = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])
          for j in js]
    return js, ts


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("b,h,hkv,s,d,causal,window,bq,bk,dtype", FA_CASES)
def test_flash_attention_matches_reference_kernel(b, h, hkv, s, d, causal,
                                                  window, bq, bk, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, b, h, hkv, s, s, d), dtype)
    kw = dict(causal=causal, window=window, block_q=bq, block_k=bk)
    oj = jops.flash_attention(jq, jk, jv, interpret=True, **kw)
    before = tops.flash_attention.launches
    ot = tops.flash_attention(tq, tk, tv, **kw)
    assert tops.flash_attention.launches == before      # plain version
    assert ot.dtype == TDT[dtype] and tuple(ot.shape) == (b, h, s, d)
    np.testing.assert_allclose(_np(ot), _np(oj), atol=ATOL[dtype])


def test_flash_attention_long_window_matches_reference_kernel():
    """A window longer than the sequence equals dense causal."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 1, 2, 2, 128, 128, 64),
                                       "float32")
    kw = dict(causal=True, block_q=64, block_k=64)
    ow = tops.flash_attention(tq, tk, tv, window=4096, **kw)
    oj = jops.flash_attention(jq, jk, jv, window=4096, interpret=True, **kw)
    np.testing.assert_allclose(_np(ow), _np(oj), atol=2e-5)
    oc = tops.flash_attention(tq, tk, tv, window=None, **kw)
    np.testing.assert_allclose(_np(ow), _np(oc), atol=1e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (False, 40),
                                           (True, 24)])
def test_top_left_alignment_when_sq_differs_from_sk(causal, window):
    """sq=64 queries over sk=128 keys: query r sits at position r (not at
    r + 64, as attention_ref would place it), exactly as in the Pallas
    kernel."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(3, 1, 4, 2, 64, 128, 32),
                                       "float32")
    kw = dict(causal=causal, window=window, block_q=64, block_k=64)
    oj = jops.flash_attention(jq, jk, jv, interpret=True, **kw)
    ot = tops.flash_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(_np(ot), _np(oj), atol=2e-5)
    bottom_right = tref.attention_ref(tq, tk, tv, causal=causal, window=window)
    assert not np.allclose(_np(ot), _np(bottom_right), atol=1e-3)


@pytest.mark.parametrize("causal,sq,sk,block_k,raises", [
    (True, 96, 96, 64, False),     # causal self-attention: padding is exact
    (False, 96, 96, 64, True),     # padded keys would be visible
    (True, 64, 96, 64, True),      # padded keys visible to late queries
    (False, 64, 128, 64, False),   # no padding needed
])
def test_kv_padding_assertion_fires_where_the_reference_fires(
        causal, sq, sk, block_k, raises):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(4, 1, 2, 2, sq, sk, 32),
                                       "float32")
    kw = dict(causal=causal, block_q=64, block_k=block_k)
    for fn, args in ((jops.flash_attention, (jq, jk, jv)),
                     (tops.flash_attention, (tq, tk, tv))):
        extra = {"interpret": True} if fn is jops.flash_attention else {}
        if raises:
            with pytest.raises(AssertionError, match="kv padding"):
                fn(*args, **kw, **extra)
        else:
            fn(*args, **kw, **extra)


def test_gqa_head_count_must_divide():
    (_, _, _), (tq, tk, tv) = _both(_qkv(5, 1, 3, 2, 64, 64, 32), "float32")
    with pytest.raises(AssertionError, match="GQA"):
        tops.flash_attention(tq, tk, tv)


@pytest.mark.parametrize("causal,window,sq,sk,dtype", [
    (True, None, 64, 64, "float32"), (False, None, 32, 96, "float32"),
    (True, 20, 48, 80, "float32"), (True, None, 64, 64, "bfloat16"),
])
def test_attention_ref_matches_reference_oracle(causal, window, sq, sk,
                                                dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(6, 2, 4, 2, sq, sk, 16), dtype)
    oj = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    ot = tref.attention_ref(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(_np(ot), _np(oj), atol=ATOL[dtype])


def test_plain_version_equals_attention_ref_when_sq_equals_sk():
    _, (tq, tk, tv) = _both(_qkv(7, 1, 4, 1, 128, 128, 64), "float32")
    for causal, window in ((True, None), (True, 50), (False, None)):
        torch.testing.assert_close(
            F.flash_attention_reference(tq, tk, tv, causal, window),
            tref.attention_ref(tq, tk, tv, causal=causal, window=window),
            atol=2e-5, rtol=0)


@pytest.mark.parametrize("bad", ["dtype", "mixed", "rank", "contiguous",
                                 "head_dim", "kv_shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    _, (q, k, v) = _both(_qkv(8, 1, 2, 2, 64, 64, 32), "float32")
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed":
        k = k.to(torch.bfloat16)
    elif bad == "rank":
        q = q[0]
    elif bad == "contiguous":
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "head_dim":
        q = torch.zeros(1, 2, 64, 320)
        k = v = torch.zeros(1, 2, 64, 320)
    else:
        v = v[:, :, :32]
    with pytest.raises(ValueError):
        F._check_launch(q, k, v)


def test_wrapper_raises_on_a_device_without_a_kernel():
    _, (q, k, v) = _both(_qkv(9, 1, 2, 2, 64, 64, 32), "float32")
    with pytest.raises(ValueError, match="no kernel"):
        tops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
