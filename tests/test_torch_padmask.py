"""Pad-masked (left-padded) prefill, per-slot cache surgery and the slot
batcher on the port's recurrent families, against the port's own
unpadded runs and the JAX package.

The port of ``tests/test_padmask.py`` on mamba2-130m (SSM states) and
llama3.2-1b (KV caches), plus recurrentgemma-9b (LRU states and a local
KV cache): a padded prefill must match the unpadded one in logits, every
cache leaf and ``pos`` (atol 3e-5, the reference's own figure).  The
batcher re-prefills each admitted request left-padded and splices its
batch-1 SSM/LRU state into the live batch, so its streams must equal solo
``Engine.generate`` runs and the JAX batcher's.  Reduced configs, the
reference's ``init_params`` converted key for key.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyp_compat import given, settings, st

from repro import accel as jaccel
from repro.configs import get_config as jget
from repro.models import init_params as jinit
from repro.models import prefill as jprefill
from repro.models import prefill_resume as jresume
from repro.serve.engine import ContinuousBatcher as JBatcher
from repro.serve.engine import ServeConfig as JServe
from repro_torch import accel as taccel
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.models import (init_cache, prefill, prefill_resume,
                                slice_slot, splice_slot)
from repro_torch.serve import ContinuousBatcher, ServeConfig
from repro_torch.tree import leaves

S_MAX = 32
PAD_TOL = dict(rtol=0, atol=3e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
JAX_NAME = {"digital": "digital", "kernel": "pallas"}


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _arch(name, layers=None):
    jc, tc = jget(name).reduced(), tget(name).reduced()
    if layers is not None:
        jc = dataclasses.replace(jc, n_layers=layers)
        tc = dataclasses.replace(tc, n_layers=layers)
    pj = jinit(jc, jax.random.PRNGKey(0), max_seq=64)
    return jc, tc, pj, params_from_jax(jax.tree.map(np.asarray, pj), "cpu")


def _prefill(params, toks, cfg, mask=None):
    with torch.inference_mode():
        return prefill(params, torch.from_numpy(toks).long(), cfg,
                       s_max=S_MAX,
                       pad_mask=None if mask is None
                       else torch.from_numpy(mask))


def _assert_cache_close(a, b, tol=PAD_TOL):
    la, lb = leaves(a.layers), leaves(b.layers)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        torch.testing.assert_close(x, y, **tol)


@settings(max_examples=8, deadline=None)
@given(name=st.sampled_from(["llama3.2-1b", "mamba2-130m"]),
       length=st.integers(min_value=1, max_value=15),
       seed=st.integers(min_value=0, max_value=2 ** 16))
def test_padded_prefill_matches_unpadded(name, length, seed):
    """A left-padded prompt (fixed width 16) against its unpadded
    prefill: logits, every cache leaf and pos; and the padded logits
    against the reference's padded prefill."""
    jc, tc, pj, pt = _arch(name)
    rng = np.random.default_rng(seed)
    prompt = rng.integers(1, tc.vocab, (1, length)).astype(np.int32)
    lg_ref, cache_ref = _prefill(pt, prompt, tc)
    pad = 16 - length
    padded = np.zeros((1, 16), np.int32)
    mask = np.zeros((1, 16), bool)
    padded[0, pad:] = prompt[0]
    mask[0, pad:] = True
    lg_pad, cache_pad = _prefill(pt, padded, tc, mask)
    torch.testing.assert_close(lg_pad, lg_ref, **PAD_TOL)
    a, b = slice_slot(cache_pad, 0), slice_slot(cache_ref, 0)
    assert a.pos.tolist() == b.pos.tolist() == [length]
    _assert_cache_close(a, b)
    lj, _ = jprefill(pj, jnp.asarray(padded), jc, s_max=S_MAX,
                     pad_mask=jnp.asarray(mask))
    np.testing.assert_allclose(lg_pad.numpy(), np.asarray(lj), **TOL)


@pytest.mark.parametrize("arch", [("llama3.2-1b", None),
                                  ("mamba2-130m", None),
                                  ("recurrentgemma-9b", None),
                                  ("recurrentgemma-9b", 5)],
                         ids=lambda a: a[0] + ("" if a[1] is None
                                               else f"-{a[1]}L"))
def test_padded_prefill_batches_ragged_rows_exactly(arch):
    """Ragged rows padded into ONE batch each match their own solo
    unpadded prefill (the batcher's admission path)."""
    _, tc, _, pt = _arch(*arch)
    rng = np.random.default_rng(0)
    lens = [2, 7, 12]
    s = max(lens)
    padded = np.zeros((len(lens), s), np.int32)
    mask = np.zeros((len(lens), s), bool)
    rows = [rng.integers(1, tc.vocab, (n,)).astype(np.int32) for n in lens]
    for i, (n, r) in enumerate(zip(lens, rows)):
        padded[i, s - n:] = r
        mask[i, s - n:] = True
    lg, cache = _prefill(pt, padded, tc, mask)
    for i, (n, r) in enumerate(zip(lens, rows)):
        lg_ref, cache_ref = _prefill(pt, r[None], tc)
        torch.testing.assert_close(lg[i], lg_ref[0], **PAD_TOL)
        sl = slice_slot(cache, i)
        assert sl.pos.tolist() == [n]
        _assert_cache_close(sl, cache_ref)


@pytest.mark.parametrize("name", ["mamba2-130m", "recurrentgemma-9b"])
def test_slice_splice_roundtrip_recurrent_states(name):
    """The stacked ``"scanned"`` SSM/LRU states keep the layer axis first
    and the batch second; slice_slot/splice_slot are exact inverses and
    splice writes the live cache in place."""
    _, tc, _, pt = _arch(name)
    toks = np.random.default_rng(2).integers(1, tc.vocab, (3, 8)).astype(
        np.int32)
    _, full = _prefill(pt, toks, tc)
    layers = tc.n_layers if name == "mamba2-130m" else 1
    state = full.layers["scanned"]["u0"]
    assert type(state).__name__ == ("SSMState" if name == "mamba2-130m"
                                    else "LRUState")
    assert all(t.shape[:2] == (layers, 3) for t in state)
    blank = init_cache(tc, 3, S_MAX, device="cpu")
    live = leaves(blank.layers)
    rebuilt = blank
    with torch.inference_mode():
        for i in range(3):
            rebuilt = splice_slot(rebuilt, slice_slot(full, i), i)
    assert all(a is b for a, b in zip(leaves(rebuilt.layers), live))
    for a, b in zip(leaves(rebuilt.layers), leaves(full.layers)):
        assert torch.equal(a, b)
    assert rebuilt.pos.tolist() == [8, 8, 8]


def _ragged_prompts(n, vocab, seed=1, lengths=(3, 9, 5, 13, 7, 4, 11, 6)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (lengths[i % len(lengths)],)
                         ).astype(np.int32) for i in range(n)]


@pytest.mark.parametrize("backend", ["digital", "kernel"])
@pytest.mark.parametrize("name", ["mamba2-130m", "recurrentgemma-9b"])
def test_batcher_streams_equal_solo_and_reference(name, backend):
    """Six ragged requests with ragged budgets on three slots: every
    stream equals the port's solo generate and the JAX batcher's, and the
    stats equal the JAX batcher's."""
    jc, tc, pj, pt = _arch(name)
    if backend != "digital":
        jc = jc.with_accel(JAX_NAME[backend], ba=4, bx=4)
        tc = tc.with_accel(backend, ba=4, bx=4)
    tb = ContinuousBatcher(pt, tc, ServeConfig(max_seq=48, max_new_tokens=6),
                           3, device="cpu")
    jb = JBatcher(pj, jc, JServe(max_seq=48, max_new_tokens=6), 3)
    prompts = _ragged_prompts(6, tc.vocab)
    budgets = (6, 2, 5, 3, 6, 4)
    rids = [tb.submit(p, max_new_tokens=m) for p, m in zip(prompts, budgets)]
    assert [jb.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, budgets)] == rids
    got, want = tb.run(), jb.run()
    for rid, p, m in zip(rids, prompts, budgets):
        solo = tb.engine.generate(torch.as_tensor(p[None]),
                                  request_ids=[rid])[0][:m].tolist()
        assert got[rid] == solo, (rid, got[rid], solo)
        assert got[rid] == want[rid], (rid, got[rid], want[rid])
    assert tb.stats == jb.stats


@pytest.mark.parametrize("backend", ["digital", "kernel"])
@pytest.mark.parametrize("name", ["mamba2-130m", "recurrentgemma-9b"])
def test_prefill_resume_recurrent(name, backend):
    """A head prefill plus a resumed chunk (the recurrent mixers' sequence
    path seeded from the carried state) against a full prefill of the
    whole prompt and the reference's resume, allclose (the SSD chunk
    split and the scan reassociate float sums).  Per-row input scales,
    as in serving."""
    jc, tc, pj, pt = _arch(name)
    if backend != "digital":
        jc = jc.with_accel(JAX_NAME[backend], ba=4, bx=4)
        tc = tc.with_accel(backend, ba=4, bx=4)
    toks = np.random.default_rng(4).integers(0, tc.vocab, (2, 24)).astype(
        np.int32)
    head, tail = toks[:, :17], toks[:, 17:]
    with torch.inference_mode(), taccel.override(x_per_row=True):
        full_logits, full = prefill(pt, torch.from_numpy(toks).long(), tc, 32)
        _, part = prefill(pt, torch.from_numpy(head).long(), tc, 32)
        logits, resumed = prefill_resume(pt, torch.from_numpy(tail).long(),
                                         tc, part)
    torch.testing.assert_close(logits, full_logits, **TOL)
    assert resumed.pos.tolist() == [24, 24]
    for a, b in zip(leaves(resumed.layers), leaves(full.layers)):
        torch.testing.assert_close(a, b, **TOL)
    with jaccel.override(x_per_row=True):
        _, jpart = jprefill(pj, jnp.asarray(head), jc, 32)
        jlogits, _ = jresume(pj, jnp.asarray(tail), jc, jpart)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


# ------------------------------------------------- MoE + MLA (deepseek-v2)

def _deepseek(backend="digital"):
    """Reduced deepseek-v2-lite-16b, dropless (capacity factor 64): expert
    capacity is shared by a batch's tokens, so only without drops does a
    batched or padded row equal its solo run."""
    jc, tc, pj, pt = _arch("deepseek-v2-lite-16b")
    jc = dataclasses.replace(jc, moe_capacity_factor=64.0)
    tc = dataclasses.replace(tc, moe_capacity_factor=64.0)
    if backend != "digital":
        jc = jc.with_accel(JAX_NAME[backend], ba=4, bx=4)
        tc = tc.with_accel(backend, ba=4, bx=4)
    return jc, tc, pj, pt


def test_padded_prefill_batches_ragged_rows_exactly_mla():
    """Ragged rows padded into one batch each match their own solo
    unpadded prefill: logits, the MLA latent and rope-key caches (written
    left-aligned) and pos."""
    _, tc, _, pt = _deepseek()
    rng = np.random.default_rng(0)
    lens = [2, 7, 12]
    s = max(lens)
    padded = np.zeros((len(lens), s), np.int32)
    mask = np.zeros((len(lens), s), bool)
    rows = [rng.integers(1, tc.vocab, (n,)).astype(np.int32) for n in lens]
    for i, (n, r) in enumerate(zip(lens, rows)):
        padded[i, s - n:] = r
        mask[i, s - n:] = True
    lg, cache = _prefill(pt, padded, tc, mask)
    assert type(cache.layers["scanned"]["u0"]).__name__ == "MLACache"
    for i, (n, r) in enumerate(zip(lens, rows)):
        lg_ref, cache_ref = _prefill(pt, r[None], tc)
        torch.testing.assert_close(lg[i], lg_ref[0], **PAD_TOL)
        sl = slice_slot(cache, i)
        assert sl.pos.tolist() == [n]
        _assert_cache_close(sl, cache_ref)


def test_slice_splice_roundtrip_mla_cache():
    """The stacked MLA caches keep the layer axis first and the batch
    second; slice_slot/splice_slot are exact inverses, in place."""
    _, tc, _, pt = _deepseek()
    toks = np.random.default_rng(2).integers(1, tc.vocab, (3, 8)).astype(
        np.int32)
    _, full = _prefill(pt, toks, tc)
    state = full.layers["scanned"]["u0"]
    n_rep = tc.n_layers - tc.first_k_dense
    assert tuple(state.c_kv.shape) == (n_rep, 3, S_MAX, tc.kv_lora_rank)
    blank = init_cache(tc, 3, S_MAX, device="cpu")
    live = leaves(blank.layers)
    rebuilt = blank
    with torch.inference_mode():
        for i in range(3):
            rebuilt = splice_slot(rebuilt, slice_slot(full, i), i)
    assert all(a is b for a, b in zip(leaves(rebuilt.layers), live))
    for a, b in zip(leaves(rebuilt.layers), leaves(full.layers)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("backend", ["digital", "kernel"])
def test_batcher_streams_equal_solo_and_reference_moe(backend):
    """deepseek-v2 (dropless) through the slot batcher: six ragged
    requests on three slots; every stream equals the port's solo generate
    and the JAX batcher's, and the stats equal the JAX batcher's."""
    jc, tc, pj, pt = _deepseek(backend)
    tb = ContinuousBatcher(pt, tc, ServeConfig(max_seq=48, max_new_tokens=6),
                           3, device="cpu")
    jb = JBatcher(pj, jc, JServe(max_seq=48, max_new_tokens=6), 3)
    prompts = _ragged_prompts(6, tc.vocab)
    budgets = (6, 2, 5, 3, 6, 4)
    rids = [tb.submit(p, max_new_tokens=m) for p, m in zip(prompts, budgets)]
    assert [jb.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, budgets)] == rids
    got, want = tb.run(), jb.run()
    for rid, p, m in zip(rids, prompts, budgets):
        solo = tb.engine.generate(torch.as_tensor(p[None]),
                                  request_ids=[rid])[0][:m].tolist()
        assert got[rid] == solo, (rid, got[rid], solo)
        assert got[rid] == want[rid], (rid, got[rid], want[rid])
    assert tb.stats == jb.stats


@pytest.mark.parametrize("backend", ["digital", "kernel"])
def test_prefill_resume_mla(backend):
    """A head prefill plus a resumed chunk written into the latent cache
    at each row's position, against the full prefill and the reference's
    resume (dropless, per-row input scales)."""
    jc, tc, pj, pt = _deepseek(backend)
    toks = np.random.default_rng(4).integers(0, tc.vocab, (2, 24)).astype(
        np.int32)
    head, tail = toks[:, :17], toks[:, 17:]
    with torch.inference_mode(), taccel.override(x_per_row=True):
        full_logits, full = prefill(pt, torch.from_numpy(toks).long(), tc, 32)
        _, part = prefill(pt, torch.from_numpy(head).long(), tc, 32)
        logits, resumed = prefill_resume(pt, torch.from_numpy(tail).long(),
                                         tc, part)
    torch.testing.assert_close(logits, full_logits, **TOL)
    assert resumed.pos.tolist() == [24, 24]
    for a, b in zip(leaves(resumed.layers), leaves(full.layers)):
        torch.testing.assert_close(a, b, **TOL)
    with jaccel.override(x_per_row=True):
        _, jpart = jprefill(pj, jnp.asarray(head), jc, 32)
        jlogits, _ = jresume(pj, jnp.asarray(tail), jc, jpart)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
