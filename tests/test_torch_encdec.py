"""Whisper's encoder-decoder, the early-fusion frontend stub, the slot
batcher on whisper, ``lm_batch``'s frontend embeddings and the analytic
parameter counts, against the JAX package.

Reduced configs (``reduced()``: d_model 128, float32; whisper at 2
encoder and 4 decoder layers and 8 frames) with the reference's
``init_params`` converted key for key and the same seeded numpy inputs.
Float results of the same operations in another summation order are held
``allclose`` at atol/rtol 1e-4 (gradients at the mamba2 test's rtol
1e-3); the grouped cross-k/v dispatch is held bit for bit to one 2-D
dispatch a layer; token streams must be identical (``kernel`` runs the
CUDA kernel's plain version on these CPU tensors, the reference
``pallas`` in interpret mode).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import accel as jaccel
from repro.configs import ALL_ARCHS as J_ALL_ARCHS
from repro.configs import get_config as jget
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import lm_batch as jlm_batch
from repro.models import counting as jcounting
from repro.models import init_params as jinit
from repro.models import loss_fn as jloss
from repro.models import prefill as jprefill
from repro.models.attention import cross_attention as jcross_attention
from repro.models.model import _cross_kv_all_layers as jcross_kv
from repro.models.model import _encode as jencode
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServe
from repro_torch import accel as taccel
from repro_torch.configs import ALL_ARCHS, get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import DataConfig, lm_batch
from repro_torch.models import (counting, decode_step, forward, init_cache,
                                loss_fn, prefill, slice_slot, splice_slot)
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.transformer import layer_slice
from repro_torch.serve import ContinuousBatcher, Engine, ServeConfig
from repro_torch.tree import leaves, unflatten

JAX_NAME = {"digital": "digital", "digital_int": "digital_int",
            "bpbs": "bpbs", "kernel": "pallas"}
TOL = dict(rtol=1e-4, atol=1e-4)
FRONTEND = ["whisper-tiny", "phi-3-vision-4.2b", "llama4-scout-17b-a16e"]
_MEASURED = dict(sparsity=None, planes_skipped=None, planes_total=None)


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _ref(name, remat=False):
    """(jax cfg, port cfg, jax params, port params) at reduced size."""
    jc = dataclasses.replace(jget(name).reduced(), remat=remat)
    tc = dataclasses.replace(tget(name).reduced(), remat=remat)
    pj = jinit(jc, jax.random.PRNGKey(0), max_seq=64)
    return jc, tc, pj, params_from_jax(jax.tree.map(np.asarray, pj), "cpu")


def _cfgs(jc, tc, backend, **kw):
    if backend == "digital":
        return jc, tc
    return (jc.with_accel(JAX_NAME[backend], ba=4, bx=4, **kw),
            tc.with_accel(backend, ba=4, bx=4, **kw))


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _frames(cfg, batch, seed=1):
    return (0.1 * np.random.default_rng(seed).standard_normal(
        (batch, cfg.frontend_seq, cfg.d_model))).astype(np.float32)


# ------------------------------------------------------------- the encoder

@pytest.mark.parametrize("backend", ["digital", "bpbs", "kernel"])
def test_encode_matches_reference(backend):
    """``_encode``: learned positions, ``enc_layers`` bidirectional
    layers through the port's ``apply_stack``, the final norm."""
    jc, tc, pj, pt = _ref("whisper-tiny")
    jc, tc = _cfgs(jc, tc, backend)
    fe = _frames(jc, 2)
    ej = jencode(pj, jnp.asarray(fe), jc, jnp.float32)
    with torch.inference_mode():
        et = tmodel._encode(pt, torch.from_numpy(fe), tc, torch.float32)
    assert tuple(et.shape) == (2, tc.frontend_seq, tc.d_model)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), **TOL)


@pytest.mark.parametrize("backend", ["digital", "bpbs", "kernel"])
def test_cross_kv_all_layers_matches_reference(backend):
    """``_cross_kv_all_layers`` against the reference's ``jax.vmap`` over
    the stacked ``cross`` params: the same keys and values, and one trace
    record a projection scaled by the layers (``calls`` = rows x L,
    ``copies`` = L), as the reference's ``vmapped`` records it."""
    jc, tc, pj, pt = _ref("whisper-tiny")
    jc, tc = _cfgs(jc, tc, backend)
    enc = np.random.default_rng(2).standard_normal(
        (2, jc.frontend_seq, jc.d_model)).astype(np.float32)
    with jaccel.trace() as jt:
        kj, vj = jcross_kv(pj, jnp.asarray(enc), jc, jnp.float32)
    with taccel.trace() as tt, torch.inference_mode():
        kt, vt = tmodel._cross_kv_all_layers(pt, torch.from_numpy(enc), tc,
                                             torch.float32)
    want = (tc.n_layers, 2, tc.frontend_seq, tc.n_kv_heads, tc.hd)
    assert tuple(kt.shape) == tuple(vt.shape) == want
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), **TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **TOL)
    assert [r.tag for r in tt] == [r.tag for r in jt] == ["cross.k",
                                                          "cross.v"]
    for a, b in zip(tt, jt):
        assert (a.calls, a.copies, a.n, a.m) == (b.calls, b.copies, b.n, b.m)
        assert a.calls == 2 * tc.frontend_seq * tc.n_layers
        assert a.copies == tc.n_layers and a.sparsity is None


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("program", [False, True])
@pytest.mark.parametrize("backend", ["digital_int", "bpbs", "kernel"])
def test_grouped_cross_kv_equals_one_call_a_layer(backend, program, per_row):
    """The grouped cross-k/v dispatch (the encoder output expanded over
    the L layers, a stride-0 group axis) equals ``encode_cross_kv`` of
    each layer on its own, bit for bit: per-tensor and per-row input
    scales, with the compiled images and without."""
    _, tc, _, pt = _ref("whisper-tiny")
    tc = tc.with_accel(backend, ba=4, bx=4, x_per_row=per_row)
    if program:
        pt = taccel.install_program(pt, taccel.build_program(pt, tc), tc)
        assert "cima" in pt["cross"]["attn"]["wk"]
    enc = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, tc.frontend_seq, tc.d_model)).astype(np.float32))
    with torch.inference_mode():
        k, v = tmodel._cross_kv_all_layers(pt, enc, tc, torch.float32)
        for i in range(tc.n_layers):
            p = layer_slice(pt["cross"], i)["attn"]
            ki, vi = tattn.encode_cross_kv(p, enc, tc, torch.float32)
            assert torch.equal(k[i], ki) and torch.equal(v[i], vi), i


@pytest.mark.parametrize("keys", [1100, 1500])
def test_chunked_cross_attention_hides_the_padded_chunk(keys):
    """Cross-attention over more than two chunks of keys runs the chunked
    path unmasked, its last chunk padded to a multiple of 512 with hidden
    slots: at a key count that is no multiple of the chunk it equals the
    reference's and the dense softmax over the same keys."""
    jc, tc, pj, pt = _ref("whisper-tiny")
    r = np.random.default_rng(keys)
    x = r.standard_normal((2, 5, jc.d_model)).astype(np.float32)
    k, v = (r.standard_normal((2, keys, jc.n_kv_heads, jc.hd))
            .astype(np.float32) for _ in range(2))
    pj0 = jax.tree.map(lambda a: a[0], pj["cross"]["attn"])
    oj = jcross_attention(pj0, jnp.asarray(x), (jnp.asarray(k),
                                                jnp.asarray(v)), jc,
                          jnp.float32)
    p0 = layer_slice(pt["cross"], 0)["attn"]
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    with torch.inference_mode():
        ot = tattn.cross_attention(p0, torch.from_numpy(x), (kt, vt), tc,
                                   torch.float32)
        q = tattn.linear(p0["wq"], torch.from_numpy(x), None,
                         torch.float32).reshape(2, 5, tc.n_heads, tc.hd)
        dense = tattn.sdpa(q, kt, vt, causal=False, dtype=torch.float32,
                           chunk=keys)
        od = tattn.linear(p0["wo"], dense.reshape(2, 5, -1), None,
                          torch.float32)
    assert keys % tattn.DEFAULT_CHUNK and keys > 2 * tattn.DEFAULT_CHUNK
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
    torch.testing.assert_close(ot, od, **TOL)


# --------------------------------------------------------- training paths

@pytest.mark.parametrize("name", FRONTEND)
def test_loss_matches_reference(name):
    """``loss_fn`` with frontend embeddings: the loss, the cross entropy
    and the target count equal the reference's; an early-fusion decoder
    scores no target below ``frontend_seq`` (7 of 15 a row of 16)."""
    jc, tc, pj, pt = _ref(name)
    toks = _tokens(jc.vocab, (2, 16))
    fe = _frames(jc, 2)
    lj, mj = jloss(pj, {"tokens": jnp.asarray(toks),
                        "frontend_embeds": jnp.asarray(fe)}, jc)
    with torch.inference_mode():
        lt, mt = loss_fn(pt, {"tokens": torch.from_numpy(toks),
                              "frontend_embeds": torch.from_numpy(fe)}, tc)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    np.testing.assert_allclose(float(mt["ce"]), float(mj["ce"]), rtol=1e-5)
    assert float(mt["tokens"]) == float(mj["tokens"]) == (
        2 * 15 if tc.is_encdec else 2 * (15 - tc.frontend_seq))


@pytest.mark.parametrize("remat", [False, True])
def test_whisper_gradients_match_reference(remat):
    """The whisper loss and its gradients on ``digital`` against
    ``jax.grad`` (every leaf, the encoder's, ``dec_pos`` and the stacked
    ``cross`` params included), with and without remat: the decoder
    layers checkpoint under autograd as the reference's scan body does,
    the grouped cross-k/v call differentiates natively."""
    jc, tc, pj, pt = _ref("whisper-tiny", remat)
    toks = _tokens(jc.vocab, (2, 12))
    fe = _frames(jc, 2)
    (lj, _), gj = jax.value_and_grad(jloss, has_aux=True)(
        pj, {"tokens": jnp.asarray(toks), "frontend_embeds": jnp.asarray(fe)},
        jc)
    ps = [t.clone().requires_grad_() for t in leaves(pt)]
    lt, _ = loss_fn(unflatten(pt, ps), {
        "tokens": torch.from_numpy(toks).long(),
        "frontend_embeds": torch.from_numpy(fe)}, tc)
    grads = torch.autograd.grad(lt, ps)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    for g, h in zip(grads, jax.tree_util.tree_leaves(gj)):
        np.testing.assert_allclose(g.numpy(), np.asarray(h), rtol=1e-3,
                                   atol=1e-5)


def test_frontend_inputs_are_checked():
    """Whisper without frame embeddings encodes zeros (the reference's
    default); an early-fusion prompt shorter than its frontend positions
    is refused."""
    _, tc, _, pt = _ref("whisper-tiny")
    toks = torch.from_numpy(_tokens(tc.vocab, (2, 6)))
    zeros = torch.zeros(2, tc.frontend_seq, tc.d_model)
    with torch.inference_mode():
        a, _ = forward(pt, toks, tc)
        b, _ = forward(pt, toks, tc, frontend_embeds=zeros)
    assert torch.equal(a, b)
    _, vc, _, pv = _ref("phi-3-vision-4.2b")
    short = torch.zeros(1, vc.frontend_seq - 1, dtype=torch.long)
    with pytest.raises(ValueError, match="frontend positions"):
        forward(pv, short, vc,
                frontend_embeds=torch.zeros(1, vc.frontend_seq, vc.d_model))


# ---------------------------------------------------------- serving paths

@pytest.mark.parametrize("length", [3, 7])
def test_padded_whisper_prefill_matches_unpadded(length):
    """A left-padded whisper prefill (learned positions gathered at the
    true indices, pads hidden) equals an unpadded prefill of the real
    tokens in logits, every cache leaf, the cross keys and values and
    ``pos``, and the reference's padded prefill."""
    jc, tc, pj, pt = _ref("whisper-tiny")
    toks = _tokens(jc.vocab, (1, length), seed=length)
    fe = _frames(jc, 1)
    padded = np.zeros((1, 8), np.int32)
    padded[0, 8 - length:] = toks[0]
    mask = np.zeros((1, 8), bool)
    mask[0, 8 - length:] = True
    with torch.inference_mode():
        lu, cu = prefill(pt, torch.from_numpy(toks).long(), tc, 16,
                         frontend_embeds=torch.from_numpy(fe))
        lp, cp = prefill(pt, torch.from_numpy(padded).long(), tc, 16,
                         frontend_embeds=torch.from_numpy(fe),
                         pad_mask=torch.from_numpy(mask))
    lj, _ = jprefill(pj, jnp.asarray(padded), jc, 16,
                     frontend_embeds=jnp.asarray(fe),
                     pad_mask=jnp.asarray(mask))
    tol = dict(rtol=0, atol=3e-5)
    torch.testing.assert_close(lp, lu, **tol)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **TOL)
    assert cp.pos.tolist() == cu.pos.tolist() == [length]
    for a, b in zip(leaves((cp.layers, cp.cross_kv)),
                    leaves((cu.layers, cu.cross_kv))):
        torch.testing.assert_close(a, b, **tol)


def test_slot_surgery_carries_cross_kv():
    """``slice_slot`` and ``splice_slot`` carry whisper's cross keys and
    values (batch at axis 1): a slot spliced into a fresh batch cache
    (``init_cache`` holds zero cross keys at full width) decodes as it
    did in its own batch."""
    _, tc, _, pt = _ref("whisper-tiny")
    toks = torch.from_numpy(_tokens(tc.vocab, (2, 6))).long()
    fe = torch.from_numpy(_frames(tc, 2))
    with torch.inference_mode():
        _, cache = prefill(pt, toks, tc, 16, frontend_embeds=fe)
        one = slice_slot(cache, 1)
        assert tuple(one.cross_kv[0].shape) == (
            tc.n_layers, 1, tc.frontend_seq, tc.n_kv_heads, tc.hd)
        live = init_cache(tc, 3, 16, device="cpu")
        assert all(not bool(t.any()) for t in live.cross_kv)
        live = splice_slot(live, one, 2)
        for a, b in zip(live.cross_kv, cache.cross_kv):
            assert torch.equal(a[:, 2], b[:, 1])
            assert not bool(a[:, :2].any())
        tok = torch.tensor([5, 7, 7])
        want, _ = decode_step(pt, tok[1:], cache, tc)
        got, _ = decode_step(pt, tok, live, tc)
    torch.testing.assert_close(got[2], want[1], **TOL)


@pytest.mark.parametrize("backend", ["digital", "kernel"])
def test_whisper_batcher_streams_equal_solo(backend):
    """``ContinuousBatcher`` on whisper: each admitted slot encodes zeros
    (no embeddings on the admission path, as in the reference) and its
    cross keys splice in with its slot; every stream equals the port's
    solo ``generate`` and the reference's (the reference's own batcher
    keeps no cross keys in its live cache and cannot serve whisper)."""
    jc, tc, pj, pt = _ref("whisper-tiny")
    jc, tc = _cfgs(jc, tc, backend)
    scfg = ServeConfig(max_seq=32, max_new_tokens=5)
    cb = ContinuousBatcher(pt, tc, scfg, n_slots=2, device="cpu")
    r = np.random.default_rng(4)
    prompts = [r.integers(0, tc.vocab, (n,)) for n in (3, 9, 5)]
    budgets = (5, 2, 4)
    rids = [cb.submit(p, max_new_tokens=m) for p, m in zip(prompts, budgets)]
    results = cb.run()
    assert cb.stats["prefills"] == 3
    je = JEngine(pj, jc, JServe(max_seq=32, max_new_tokens=5))
    for rid, p, m in zip(rids, prompts, budgets):
        solo = cb.engine.generate(torch.as_tensor(p[None]),
                                  request_ids=[rid])[0][:m]
        ref = np.asarray(je.generate(jnp.asarray(p[None], jnp.int32)))[0][:m]
        assert results[rid] == solo.tolist() == ref.tolist(), rid


def test_program_tags_and_trace_match_reference_whisper():
    """``build_program`` tags whisper's cross-attention ``cross.*`` (the
    stack compiled as L copies) beside the encoder's and decoder's
    ``attn.*``/``mlp.*``; a traced prefill records the same calls per tag
    as the reference (47 records here: per layer, where the reference's
    scans record 17 scaled ones), every one served by an image, and
    ``energy_summary`` with the measured fields cleared equals the
    reference's."""
    jc, tc, pj, pt = _ref("whisper-tiny")
    jc, tc = _cfgs(jc, tc, "kernel")
    jp = jaccel.build_program(pj, jc)
    tp = taccel.build_program(pt, tc)
    assert sorted(tp.images) == sorted(jp.images)
    assert {p: i.tag for p, i in tp.images.items()} == \
        {p: i.tag for p, i in jp.images.items()}
    assert tp.summary() == jp.summary()
    assert {i.tag for i in tp.images.values()} == {
        "attn.q", "attn.k", "attn.v", "attn.o", "cross.q", "cross.k",
        "cross.v", "cross.o", "mlp.up", "mlp.down", "unembed"}
    assert all(i.copies == tc.n_layers for i in tp.images.values()
               if i.tag.startswith("cross."))
    pj = jaccel.install_program(pj, jp, jc)
    pt = taccel.install_program(pt, tp, tc)
    toks = _tokens(jc.vocab, (2, 8))
    with jaccel.trace() as jt:
        jprefill(pj, jnp.asarray(toks), jc, 16)
    with taccel.trace() as tt, torch.inference_mode():
        prefill(pt, torch.from_numpy(toks).long(), tc, 16)

    def calls(records):
        out = {}
        for r in records:
            out[r.tag] = out.get(r.tag, 0) + r.calls
        return out

    assert calls(tt) == calls(jt)
    assert all(r.program for r in tt)
    assert len(tt) == tc.enc_layers * 6 + 2 + tc.n_layers * 8 + 1
    ts = taccel.energy_summary([dataclasses.replace(r, **_MEASURED)
                                for r in tt])
    js = jaccel.energy_summary([dataclasses.replace(r, **_MEASURED)
                                for r in jt])
    for k in ("total_cycles", "load_cycles", "input_sparsity", "plane_skip"):
        assert ts[k] == js[k], k
    for k in ("total_pj", "post_pj"):
        assert ts[k] == pytest.approx(js[k], rel=1e-12, abs=0.0), k
    assert {t: row["mvms"] for t, row in ts["by_tag"].items()} == \
        {t: row["mvms"] for t, row in js["by_tag"].items()}


# ------------------------------------------------------- data and counts

@pytest.mark.parametrize("step", [0, 3])
def test_lm_batch_frontend_embeds_bitwise(step):
    """``lm_batch`` with a frontend: tokens and embeddings bitwise the
    reference's numpy stream."""
    kw = dict(seq_len=12, global_batch=3, vocab=97, seed=5, frontend_seq=8,
              d_model=16)
    bj = jlm_batch(JDataConfig(**kw), step)
    bt = lm_batch(DataConfig(**kw), step, device="cpu")
    assert sorted(bt) == sorted(bj) == ["frontend_embeds", "tokens"]
    for k in bt:
        assert bt[k].dtype == {"tokens": torch.int32,
                               "frontend_embeds": torch.float32}[k]
        np.testing.assert_array_equal(bt[k].numpy(), np.asarray(bj[k]))


@pytest.mark.parametrize("name", sorted(J_ALL_ARCHS))
def test_param_count_matches_reference(name):
    """``counting.param_count`` (total and active) and ``model_flops``
    equal the reference's for every config, whisper's encoder and cross
    attention included."""
    assert name in ALL_ARCHS
    tc, jc = tget(name), jget(name)
    for active in (False, True):
        assert counting.param_count(tc, active) == \
            jcounting.param_count(jc, active)
    assert counting.model_flops(tc, 4096, "train") == \
        jcounting.model_flops(jc, 4096, "train")
    assert counting.layer_params(tc, tc.pattern()[0], True) == \
        jcounting.layer_params(jc, jc.pattern()[0], True)
