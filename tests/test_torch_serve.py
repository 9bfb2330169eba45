"""The port's slot-level continuous batcher against its own solo engine
and against the JAX package's batcher.

Reduced olmo-1b (4 layers, d_model 128, float32) with the reference's
``init_params`` converted key for key.  Backends ``digital`` and
``kernel`` (the CUDA kernel's plain version on these CPU tensors; the
reference runs ``pallas`` in interpret mode).  Greedy token streams and
batcher stats must be identical; the resumed prefill is ``allclose`` to a
full prefill (atol/rtol 1e-4, as the port's other float logits), since the
reference's own bitwise check of it fails on this tree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from repro_torch.serve import ContinuousBatcher, Engine, ServeConfig
from repro_torch.serve import engine as engine_mod

JAX_NAME = {"digital": "digital", "kernel": "pallas"}
TOL = dict(rtol=1e-4, atol=1e-4)
BACKENDS = ["digital", "kernel"]


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ref():
    jc = jget("olmo-1b").reduced()
    pj = jinit(jc, jax.random.PRNGKey(0), max_seq=64)
    pt = params_from_jax(jax.tree.map(np.asarray, pj), "cpu")
    return jc, tget("olmo-1b").reduced(), pj, pt


def _cfgs(ref, backend):
    jc, tc = ref[0], ref[1]
    if backend == "digital":
        return jc, tc
    return (jc.with_accel(JAX_NAME[backend], ba=4, bx=4),
            tc.with_accel(backend, ba=4, bx=4))


def _ragged_prompts(n, vocab, seed=1, lengths=(3, 9, 5, 13, 7, 4, 11, 6)):
    """tests/test_serve.py's ragged prompts."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (lengths[i % len(lengths)],)
                         ).astype(np.int32) for i in range(n)]


def _batchers(ref, backend, n_slots, **scfg_kw):
    jc, tc = _cfgs(ref, backend)
    tb = ContinuousBatcher(ref[3], tc, ServeConfig(max_seq=48, **scfg_kw),
                           n_slots, device="cpu")
    jb = JBatcher(ref[2], jc, JServe(max_seq=48, **scfg_kw), n_slots)
    return tb, jb


def _solo(engine, prompt, rid):
    return engine.generate(torch.as_tensor(prompt[None]),
                           request_ids=[rid])[0].tolist()


@pytest.mark.parametrize("backend", BACKENDS)
def test_slot_splice_parity_greedy(ref, backend):
    """Six ragged prompts through three slots: every request's stream
    equals the port's solo Engine.generate of it and the JAX batcher's."""
    tb, jb = _batchers(ref, backend, 3, max_new_tokens=6)
    prompts = _ragged_prompts(6, ref[1].vocab)
    rids = [tb.submit(p) for p in prompts]
    assert [jb.submit(p) for p in prompts] == rids
    got, want = tb.run(), jb.run()
    for rid, p in zip(rids, prompts):
        assert got[rid] == _solo(tb.engine, p, rid), rid
        assert got[rid] == want[rid], (rid, got[rid], want[rid])
    assert tb.stats == jb.stats


@pytest.mark.parametrize("backend", BACKENDS)
def test_slot_splice_parity_with_eos_truncation(ref, backend):
    """A token the greedy run emits mid-stream becomes EOS: the batcher
    truncates where the solo engine (trimmed) does, frees slots early,
    and matches the JAX batcher."""
    tb0, _ = _batchers(ref, backend, 2, max_new_tokens=8)
    prompts = _ragged_prompts(5, ref[1].vocab)
    rids0 = [tb0.submit(p) for p in prompts]
    res0 = tb0.run()
    eos = next(t for r in rids0 for t in res0[r][1:-1])

    tb, jb = _batchers(ref, backend, 2, max_new_tokens=8, eos_id=int(eos))
    rids = [tb.submit(p) for p in prompts]
    [jb.submit(p) for p in prompts]
    got, want = tb.run(), jb.run()
    truncated = 0
    for rid, p in zip(rids, prompts):
        solo = _solo(tb.engine, p, rid)
        if eos in solo:
            solo = solo[: solo.index(eos) + 1]
            truncated += 1
        assert got[rid] == solo, (rid, got[rid], solo)
        assert got[rid] == want[rid]
    assert truncated, "EOS never fired; the test is vacuous"
    assert tb.stats["decode_steps"] < tb0.stats["decode_steps"]
    assert tb.stats == jb.stats


@pytest.mark.parametrize("backend", BACKENDS)
def test_per_request_budgets_and_streaming(ref, backend):
    tb, _ = _batchers(ref, backend, 2, max_new_tokens=6)
    prompts = _ragged_prompts(6, ref[1].vocab)
    budgets = (1, 3, 6, 2, 4, 5)
    rids = [tb.submit(p, max_new_tokens=m) for p, m in zip(prompts, budgets)]
    stream = []
    results = tb.run(on_token=lambda rid, tok: stream.append((rid, tok)))
    assert [len(results[r]) for r in rids] == list(budgets)
    per_req = {}
    for rid, tok in stream:
        per_req.setdefault(rid, []).append(tok)
    assert per_req == results


@pytest.mark.parametrize("backend", BACKENDS)
def test_slot_utilization_beats_generational_on_ragged_budgets(ref, backend):
    """On ragged budgets the slot loop retires and refills slots instead
    of decoding whole waves to the longest budget; both loops' stats
    equal the JAX batcher's exactly."""
    prompts = _ragged_prompts(6, ref[1].vocab)
    budgets = (2, 16, 4, 2, 8, 4)
    stats = {}
    for mode in ("run_generational", "run"):
        tb, jb = _batchers(ref, backend, 2, max_new_tokens=16)
        for p, m in zip(prompts, budgets):
            tb.submit(p, max_new_tokens=m)
            jb.submit(p, max_new_tokens=m)
        got, want = getattr(tb, mode)(), getattr(jb, mode)()
        assert got == want
        assert tb.stats == jb.stats, (mode, tb.stats, jb.stats)
        stats[mode] = tb.stats
    slot, gen = stats["run"], stats["run_generational"]
    assert slot["generated_tokens"] == gen["generated_tokens"]

    def tokens_per_step(s):
        return s["generated_tokens"] / (s["decode_steps"] + s["prefills"])

    assert tokens_per_step(slot) > tokens_per_step(gen), (slot, gen)


def test_batcher_at_temperature_matches_solo_engine(ref):
    """Sampling is a function of (seed, request id, step): the batcher's
    sampled streams equal the solo engine's for the same ids, whatever
    the slot layout.  (Torch cannot reproduce JAX's fold_in keys, so
    this holds the port to itself.)"""
    _, tc = _cfgs(ref, "kernel")
    scfg = ServeConfig(max_seq=48, max_new_tokens=5, temperature=0.8,
                       seed=3)
    prompts = _ragged_prompts(4, tc.vocab)
    tb = ContinuousBatcher(ref[3], tc, scfg, 2, device="cpu")
    rids = [tb.submit(p) for p in prompts]
    got = tb.run()
    for rid, p in zip(rids, prompts):
        assert got[rid] == _solo(tb.engine, p, rid)


def test_slice_splice_roundtrip_in_place(ref):
    """slice_slot/splice_slot are exact inverses, and splice writes the
    live cache in place: its tensors stay the same objects and every
    other slot keeps its bits."""
    _, tc = _cfgs(ref, "digital")
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, tc.vocab, (3, 8)))
    with torch.inference_mode():
        _, full = prefill(ref[3], toks, tc, s_max=32)
        blank = init_cache(tc, 3, 32, device="cpu")
        live_k = blank.layers["scanned"]["u0"].k
        rebuilt = blank
        for i in range(3):
            before = live_k.clone()
            rebuilt = splice_slot(rebuilt, slice_slot(full, i), i)
            assert rebuilt.layers["scanned"]["u0"].k is live_k
            others = [j for j in range(3) if j != i]
            assert torch.equal(live_k[:, others], before[:, others])
    for a, b in zip((full.layers["scanned"]["u0"].k,
                     full.layers["scanned"]["u0"].v, full.pos),
                    (rebuilt.layers["scanned"]["u0"].k,
                     rebuilt.layers["scanned"]["u0"].v, rebuilt.pos)):
        assert torch.equal(a, b)
    assert rebuilt.pos is blank.pos and rebuilt.pos.tolist() == [8, 8, 8]


@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_resume_matches_full_prefill(ref, backend):
    """A head prefill plus a resumed chunk equals a full prefill of the
    whole prompt (logits and cache) and the reference's resume.  Inputs
    are quantized per row, as in serving: a per-tensor scale would differ
    between a chunk and the whole prompt."""
    jc, tc = _cfgs(ref, backend)
    toks = np.random.default_rng(4).integers(0, tc.vocab, (2, 12))
    head, tail = toks[:, :7], toks[:, 7:]
    with torch.inference_mode(), taccel.override(x_per_row=True):
        full_logits, full = prefill(ref[3], torch.from_numpy(toks), tc, 16)
        _, part = prefill(ref[3], torch.from_numpy(head), tc, 16)
        logits, resumed = prefill_resume(ref[3], torch.from_numpy(tail), tc,
                                         part)
    torch.testing.assert_close(logits, full_logits, **TOL)
    assert resumed.pos.tolist() == [12, 12]
    for name in ("k", "v"):
        torch.testing.assert_close(
            getattr(resumed.layers["scanned"]["u0"], name)[:, :, :12],
            getattr(full.layers["scanned"]["u0"], name)[:, :, :12], **TOL)
    with jaccel.override(x_per_row=True):
        _, jpart = jprefill(ref[2], jnp.asarray(head, jnp.int32), jc, 16)
        jlogits, _ = jresume(ref[2], jnp.asarray(tail, jnp.int32), jc, jpart)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


@pytest.mark.parametrize("cap", [0, -1])
def test_max_admit_per_step_validation(cap):
    with pytest.raises(ValueError, match="max_admit_per_step"):
        ServeConfig(max_admit_per_step=cap)
    assert ServeConfig(max_admit_per_step=None).max_admit_per_step is None


def test_uncapped_admission_serves_a_burst_like_the_reference(ref):
    """max_admit_per_step=None admits greedily; the streams and stats
    still equal the JAX batcher's."""
    tb, jb = _batchers(ref, "digital", 3, max_new_tokens=4,
                       max_admit_per_step=None)
    prompts = _ragged_prompts(7, ref[1].vocab)
    for p in prompts:
        tb.submit(p)
        jb.submit(p)
    assert tb.run() == jb.run()
    assert tb.stats == jb.stats


def test_batcher_defaults_to_the_card(ref):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        ContinuousBatcher(ref[3], ref[1], ServeConfig(), 2)


def test_prefill_single_buckets_and_pads_left(ref):
    _, tc = _cfgs(ref, "digital")
    eng = Engine(ref[3], tc, ServeConfig(max_seq=48), device="cpu")
    prompt = _ragged_prompts(1, tc.vocab, lengths=(11,))[0]
    logits, cache = eng.prefill_single(prompt)
    with torch.inference_mode():
        dense, _ = prefill(eng.params, torch.from_numpy(prompt[None]), tc, 48)
    assert engine_mod._bucket(11) == 16 and engine_mod._bucket(3) == 8
    assert cache.pos.tolist() == [11]
    torch.testing.assert_close(logits, dense, **TOL)
