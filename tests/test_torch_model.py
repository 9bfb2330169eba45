"""The port's model and serving path against the JAX package, end to end.

Reduced olmo-1b (``get_config("olmo-1b").reduced()``: 4 layers, d_model
128, float32) with the reference's ``init_params`` converted key for key
by ``repro_torch.convert.params_from_jax``.  Logits are float32 results of
the same operations in another summation order (XLA vs torch reductions
in the norms, softmax and float GEMMs), so they are held ``allclose`` at
atol/rtol 1e-4; the quantizing backends share the integer grids exactly.
Greedy token streams must be identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import accel as jaccel
from repro.configs import get_config as jget
from repro.models import decode_step as jdecode
from repro.models import init_params as jinit
from repro.models import prefill as jprefill
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServe
from repro_torch import accel as taccel
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.models import decode_step as tdecode
from repro_torch.models import init_params as tinit
from repro_torch.models import prefill as tprefill
from repro_torch.serve import Engine as TEngine
from repro_torch.serve import ServeConfig as TServe

JAX_NAME = {"digital": "digital", "bpbs": "bpbs", "kernel": "pallas"}
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ref():
    jc = jget("olmo-1b").reduced()
    pj = jinit(jc, jax.random.PRNGKey(0))
    pt = params_from_jax(jax.tree.map(np.asarray, pj), "cpu")
    toks = np.random.default_rng(0).integers(0, jc.vocab, (2, 8))
    return jc, tget("olmo-1b").reduced(), pj, pt, toks.astype(np.int32)


def _cfgs(ref, backend):
    jc, tc = ref[0], ref[1]
    if backend == "digital":
        return jc, tc
    return (jc.with_accel(JAX_NAME[backend], ba=4, bx=4),
            tc.with_accel(backend, ba=4, bx=4))


def _programmed(ref, jc, tc):
    pj = jaccel.install_program(ref[2], jaccel.build_program(ref[2], jc), jc)
    pt = taccel.install_program(ref[3], taccel.build_program(ref[3], tc), tc)
    return pj, pt


def test_converted_tree_matches_reference_key_for_key(ref):
    jc, tc, pj, pt, _ = ref
    jl = jax.tree_util.tree_leaves_with_path(pj)
    flat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in jl}
    port = tinit(tc, 0, device="cpu")
    for key, v in flat.items():
        node_pt, node_init = pt, port
        for part in key.strip("[]'").split("']['"):
            node_pt, node_init = node_pt[part], node_init[part]
        np.testing.assert_array_equal(node_pt.numpy(), v)
        assert tuple(node_init.shape) == v.shape
    assert pt["stack"]["scanned"]["u0"]["mlp"]["down"]["w"].shape[0] == 4


@pytest.mark.parametrize("program", [False, True])
@pytest.mark.parametrize("backend", ["digital", "bpbs", "kernel"])
def test_prefill_and_decode_logits(ref, backend, program):
    jc, tc = _cfgs(ref, backend)
    pj, pt = _programmed(ref, jc, tc) if program else (ref[2], ref[3])
    toks = ref[4]
    lj, cj = jprefill(pj, jnp.asarray(toks), jc, 16)
    with torch.inference_mode():
        lt, ct = tprefill(pt, torch.from_numpy(toks).long(), tc, 16)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    nxt = np.asarray(jnp.argmax(lj, -1))
    lj2, _ = jdecode(pj, jnp.asarray(nxt), cj, jc)
    with torch.inference_mode():
        lt2, ct2 = tdecode(pt, torch.tensor(nxt).long(), ct, tc)
    np.testing.assert_allclose(lt2.numpy(), np.asarray(lj2), **TOL)
    assert ct2.pos.tolist() == [9, 9]


@pytest.mark.parametrize("program", [False, True])
@pytest.mark.parametrize("backend", ["digital", "bpbs", "kernel"])
def test_generate_greedy_streams_identical(ref, backend, program):
    jc, tc = _cfgs(ref, backend)
    toks = ref[4]
    je = JEngine(ref[2], jc, JServe(max_seq=32, max_new_tokens=6,
                                    use_program=program))
    te = TEngine(ref[3], tc, TServe(max_seq=32, max_new_tokens=6,
                                    use_program=program), device="cpu")
    assert (te.program is not None) == (program and backend != "digital")
    gj = je.generate(jnp.asarray(toks))
    gt = te.generate(torch.from_numpy(toks))
    np.testing.assert_array_equal(gt, gj)


def test_trace_calls_per_tag_match_reference(ref):
    jc, tc = _cfgs(ref, "kernel")
    pj, pt = _programmed(ref, jc, tc)
    toks = ref[4]
    with jaccel.trace() as jt:
        jprefill(pj, jnp.asarray(toks), jc, 16)
    with taccel.trace() as tt, torch.inference_mode():
        tprefill(pt, torch.from_numpy(toks).long(), tc, 16)

    def calls(records):
        out = {}
        for r in records:
            out[r.tag] = out.get(r.tag, 0) + r.calls
        return out

    assert calls(tt) == calls(jt)
    # one record per layer and projection, every one served by an image
    assert len(tt) == 4 * 7 + 1 and all(r.program for r in tt)


def test_padded_prefill_matches_unpadded(ref):
    _, tc = _cfgs(ref, "kernel")
    pt = ref[3]
    toks = torch.from_numpy(ref[4]).long()
    padded = torch.cat([torch.zeros(2, 3, dtype=torch.long), toks], 1)
    mask = torch.cat([torch.zeros(2, 3, dtype=torch.bool),
                      torch.ones(2, 8, dtype=torch.bool)], 1)
    with torch.inference_mode(), taccel.override(x_per_row=True):
        a, ca = tprefill(pt, toks, tc, 16)
        b, cb = tprefill(pt, padded, tc, 16, pad_mask=mask)
    torch.testing.assert_close(a, b, **TOL)
    assert cb.pos.tolist() == [8, 8]
    k_a = ca.layers["scanned"]["u0"].k[:, :, :8]
    k_b = cb.layers["scanned"]["u0"].k[:, :, :8]
    torch.testing.assert_close(k_a, k_b, **TOL)


def test_sampling_is_a_function_of_seed_and_request(ref):
    _, tc = _cfgs(ref, "bpbs")
    toks = torch.from_numpy(ref[4])

    def run(seed, rids=None):
        e = TEngine(ref[3], tc, TServe(max_seq=32, max_new_tokens=5,
                                       temperature=1.0, seed=seed),
                    device="cpu")
        return e.generate(toks, request_ids=rids)

    a = run(1)
    np.testing.assert_array_equal(a, run(1))
    assert not np.array_equal(a, run(2))
    # a request's stream follows its own id, whichever row it sits in
    e = TEngine(ref[3], tc, TServe(max_seq=32, max_new_tokens=5,
                                   temperature=1.0, seed=1), device="cpu")
    flipped = e.generate(toks.flip(0), request_ids=[1, 0])
    np.testing.assert_array_equal(flipped[::-1], a)


def test_eos_early_exit_pads_with_eos(ref):
    _, tc = _cfgs(ref, "kernel")
    toks = torch.from_numpy(ref[4])
    full = TEngine(ref[3], tc, TServe(max_seq=32, max_new_tokens=6),
                   device="cpu").generate(toks)
    eos = int(full[0, 0])
    stop = TEngine(ref[3], tc, TServe(max_seq=32, max_new_tokens=6,
                                      eos_id=eos, eos_check_every=1),
                   device="cpu")
    out = stop.generate(toks[:1])
    assert out.shape == (1, 6) and (out[0] == eos).all()
    assert stop.last_decode_steps == 0
    cache = stop.init_cache(3)
    assert tuple(cache.layers["scanned"]["u0"].k.shape) == (4, 3, 32, 4, 32)
    assert cache.pos.tolist() == [0, 0, 0]


@pytest.mark.parametrize("bad", [dict(max_seq=0), dict(max_new_tokens=-1),
                                 dict(eos_check_every=0),
                                 dict(temperature=-0.5)])
def test_serve_config_validation(bad):
    with pytest.raises(ValueError):
        TServe(**bad)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = tget("olmo-1b").reduced()
    with pytest.raises((RuntimeError, AssertionError)):
        tinit(cfg, 0)
    with pytest.raises((RuntimeError, AssertionError)):
        TEngine({"w": torch.zeros(1)}, cfg, TServe())


@pytest.mark.parametrize("window", [None, 300])
def test_chunked_attention_matches_reference_and_dense(window):
    """Past 2*DEFAULT_CHUNK keys sdpa takes the chunked online-softmax
    path (a max_seq=2048 cache); hold it to the reference's chunked path
    and to the port's dense path, with ring positions and hidden slots."""
    from repro.models import attention as ja
    from repro_torch.models import attention as ta

    r = np.random.default_rng(9)
    b, sq, sk, h, kv, d = 2, 3, 1100, 4, 2, 16
    q = r.normal(size=(b, sq, h, d)).astype(np.float32)
    k = r.normal(size=(b, sk, kv, d)).astype(np.float32)
    v = r.normal(size=(b, sk, kv, d)).astype(np.float32)
    cp = np.array([1000, 1500])
    kv_pos = np.asarray(ja.ring_slot_positions(sk, jnp.asarray(cp)))
    np.testing.assert_array_equal(
        ta.ring_slot_positions(sk, torch.tensor(cp)).numpy(), kv_pos)
    q_pos = cp[:, None] - np.arange(sq)[::-1][None]
    kw = dict(causal=True, window=window, q_offset=0, scale=d ** -0.5,
              dtype=jnp.float32)
    oj = ja._chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               kv_positions=jnp.asarray(kv_pos),
                               q_positions=jnp.asarray(q_pos), **kw)
    targs = [torch.from_numpy(a) for a in (q, k, v)]
    tkw = dict(kw, dtype=torch.float32, kv_positions=torch.tensor(kv_pos),
               q_positions=torch.tensor(q_pos))
    ot = ta.sdpa(*targs, **{k_: v_ for k_, v_ in tkw.items()
                            if k_ != "q_offset"})
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5,
                               atol=1e-5)
    od = ta._dense_attention(*targs, **tkw)
    torch.testing.assert_close(ot, od, rtol=1e-5, atol=1e-5)


def test_chunked_attention_bf16_probs_matches_reference(monkeypatch):
    """``attn_bf16_probs``: past 2*DEFAULT_CHUNK keys the chunked path
    feeds bf16 probabilities and V into the PV product (f32 sums), as the
    reference does.  Held to the reference's chunked path at atol 5e-5:
    the f32 probabilities differ by an ulp or so between the packages, and
    one that lands across a bf16 rounding boundary moves the output by up
    to p * 2**-8 * |v|.  The flag itself moves this output by 3.7e-4, so
    the test asserts more than 2e-4; and attention() must pass the
    config's flag on."""
    import dataclasses

    from repro.models import attention as ja
    from repro_torch.models import attention as ta

    r = np.random.default_rng(9)
    b, sq, sk, h, kv, d = 2, 3, 1100, 4, 2, 16
    q = r.normal(size=(b, sq, h, d)).astype(np.float32)
    k = r.normal(size=(b, sk, kv, d)).astype(np.float32)
    v = r.normal(size=(b, sk, kv, d)).astype(np.float32)
    kw = dict(causal=False, window=None, q_offset=0, scale=d ** -0.5)
    oj = ja._chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               dtype=jnp.float32, bf16_probs=True, **kw)
    targs = [torch.from_numpy(a) for a in (q, k, v)]
    tkw = {k_: v_ for k_, v_ in kw.items() if k_ != "q_offset"}
    ot = ta.sdpa(*targs, dtype=torch.float32, bf16_probs=True, **tkw)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0,
                               atol=5e-5)
    o32 = ta.sdpa(*targs, dtype=torch.float32, **tkw)
    assert float((ot - o32).abs().max()) > 2e-4

    seen = []
    real = ta.sdpa

    def spy(*a, **k_):
        seen.append(k_.get("bf16_probs"))
        return real(*a, **k_)

    cfg = dataclasses.replace(tget("olmo-1b").reduced(),
                              attn_bf16_probs=True)
    params = tinit(cfg, 0, device="cpu")["stack"]["scanned"]["u0"]["attn"]
    params = {n: {"w": w["w"][0]} for n, w in params.items()}
    monkeypatch.setattr(ta, "sdpa", spy)
    ta.attention(params, torch.zeros(1, 4, cfg.d_model), cfg,
                 torch.arange(4), dtype=torch.float32)
    assert seen == [True]


def test_left_align_matches_reference():
    from repro.models import attention as ja
    from repro_torch.models import attention as ta

    x = np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 3)
    mask = np.array([[0, 0, 1, 1, 1], [1, 1, 1, 1, 1]], bool)
    np.testing.assert_array_equal(
        ta.left_align(torch.from_numpy(x), torch.from_numpy(mask)).numpy(),
        np.asarray(ja.left_align(jnp.asarray(x), jnp.asarray(mask))))
