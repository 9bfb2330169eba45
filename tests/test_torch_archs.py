"""The port's model families against the JAX package, per architecture:
the recurrent ones (mamba2-130m: SSM; recurrentgemma-9b: RG-LRU + local
attention, at its reduced 3 layers and at 5, so the stack's suffix runs),
the three dense configs that ride along (llama3.2-1b, granite-8b,
starcoder2-3b), the MoE + MLA deepseek-v2-lite-16b (a dense first
layer, then MoE layers: 8 experts top-2 and 2 shared when reduced), the
encoder-decoder whisper-tiny (2 encoder and 4 decoder layers, 8 frames
when reduced) and the early-fusion phi-3-vision-4.2b and
llama4-scout-17b-a16e (8 frontend positions when reduced; llama4's MoE:
8 experts top-1 and 1 shared).  The frontend configs get the same
seeded frame or patch embeddings in both packages.

The families run in two files, so that parallel workers take one each:
this one the recurrent and dense configs and whisper-tiny (``HERE``),
``test_torch_archs_moe.py`` the MoE and early-fusion ones (``THERE``),
each the same tests on its own configs.

Reduced configs (``reduced()``: d_model 128, float32) with the
reference's ``init_params`` converted key for key.  Logits are float32
results of the same operations in another summation order, held
``allclose`` at atol/rtol 1e-4; greedy token streams must be identical,
on ``digital``, ``bpbs`` and ``kernel`` (the CUDA kernel's plain version
on these CPU tensors; the reference runs ``pallas`` in interpret mode).
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
from repro.models import decode_step as jdecode
from repro.models import forward as jforward
from repro.models import init_params as jinit
from repro.models import loss_fn as jloss
from repro.models import prefill as jprefill
from repro.models import prefill_resume as jresume
from repro.models.model import init_cache as jinit_cache
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServe
from repro_torch import accel as taccel
from repro_torch.configs import ALL_ARCHS, get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.models import decode_step as tdecode
from repro_torch.models import forward as tforward
from repro_torch.models import init_cache as tinit_cache
from repro_torch.models import init_params as tinit
from repro_torch.models import loss_fn as tloss
from repro_torch.models import prefill as tprefill
from repro_torch.models import prefill_resume as tresume
from repro_torch.serve import Engine as TEngine
from repro_torch.serve import ServeConfig as TServe
from repro_torch.tree import leaves, leaves_with_path, unflatten

JAX_NAME = {"digital": "digital", "bpbs": "bpbs", "kernel": "pallas"}
TOL = dict(rtol=1e-4, atol=1e-4)
RECURRENT = [("mamba2-130m", None), ("recurrentgemma-9b", None),
             ("recurrentgemma-9b", 5)]
DENSE = [("llama3.2-1b", None), ("granite-8b", None),
         ("starcoder2-3b", None)]
MOE = [("deepseek-v2-lite-16b", None)]
FRONTEND = [("whisper-tiny", None), ("phi-3-vision-4.2b", None),
            ("llama4-scout-17b-a16e", None)]
ARCHS = RECURRENT + DENSE + MOE + FRONTEND
# this file's configs, and test_torch_archs_moe.py's
HERE = RECURRENT + DENSE + FRONTEND[:1]
THERE = MOE + FRONTEND[1:]


def _id(arch):
    name, layers = arch
    return name if layers is None else f"{name}-{layers}L"


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _ref(name, layers=None):
    """(jax cfg, port cfg, jax params, port params) at reduced size."""
    jc, tc = jget(name).reduced(), tget(name).reduced()
    if layers is not None:
        jc = dataclasses.replace(jc, n_layers=layers)
        tc = dataclasses.replace(tc, n_layers=layers)
    pj = jinit(jc, jax.random.PRNGKey(0), max_seq=256)
    pt = params_from_jax(jax.tree.map(np.asarray, pj), "cpu")
    return jc, tc, pj, pt


def _cfgs(jc, tc, backend):
    if backend == "digital":
        return jc, tc
    return (jc.with_accel(JAX_NAME[backend], ba=4, bx=4),
            tc.with_accel(backend, ba=4, bx=4))


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _frontend(cfg, batch, seed=1):
    """Seeded frame or patch embeddings [B, frontend_seq, d] for a
    frontend config (None for the others), as the reference's tests make
    theirs: 0.1 x a standard normal."""
    if cfg.frontend == "none":
        return None
    return (0.1 * np.random.default_rng(seed).standard_normal(
        (batch, cfg.frontend_seq, cfg.d_model))).astype(np.float32)


def _pair(fe):
    """The same embeddings for the reference (jnp) and the port (torch)."""
    if fe is None:
        return None, None
    return jnp.asarray(fe), torch.from_numpy(fe)


def test_all_archs_registered():
    assert set(ALL_ARCHS) == {"olmo-1b", "llama3.2-1b", "granite-8b",
                              "starcoder2-3b", "mamba2-130m",
                              "recurrentgemma-9b", "deepseek-v2-lite-16b",
                              "whisper-tiny", "phi-3-vision-4.2b",
                              "llama4-scout-17b-a16e"}
    assert set(ALL_ARCHS) == set(J_ALL_ARCHS)
    for name in ALL_ARCHS:
        jc, tc = jget(name), tget(name)
        fields = [f.name for f in dataclasses.fields(tc) if f.name != "policy"]
        assert [getattr(tc, f) for f in fields] == \
            [getattr(jc, f) for f in fields], name


@pytest.mark.parametrize("arch", HERE, ids=_id)
def test_port_init_matches_reference_tree(arch):
    """The port's own ``init_params`` has the reference's keys and shapes;
    the converted tree holds the reference's values."""
    jc, tc, pj, pt = _ref(*arch)
    ref = {k: np.asarray(v) for k, v in leaves_with_path(
        jax.tree.map(np.asarray, pj))}
    own = dict(leaves_with_path(tinit(tc, 0, device="cpu", max_seq=256)))
    conv = dict(leaves_with_path(pt))
    assert sorted(own) == sorted(ref) == sorted(conv)
    for k, v in ref.items():
        assert tuple(own[k].shape) == v.shape, k
        np.testing.assert_array_equal(conv[k].numpy(), v)


@pytest.mark.parametrize("arch", HERE, ids=_id)
def test_forward_logits_match_reference(arch):
    jc, tc, pj, pt = _ref(*arch)
    toks = _tokens(jc.vocab, (2, 16))
    fj, ft = _pair(_frontend(jc, 2))
    lj, aj = jforward(pj, jnp.asarray(toks), jc, frontend_embeds=fj)
    with torch.inference_mode():
        lt, aux = tforward(pt, torch.from_numpy(toks).long(), tc,
                           frontend_embeds=ft)
    assert tuple(lt.shape) == (2, 16, tc.vocab)
    assert bool(torch.isfinite(lt).all())
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    # the MoE layers' summed load-balancing loss (0 without MoE layers)
    np.testing.assert_allclose(float(aux), float(aj), rtol=1e-6)
    assert (float(aux) > 0) == tc.moe


@pytest.mark.parametrize("arch", HERE, ids=_id)
def test_prefill_decode_matches_forward(arch):
    """Cache correctness (the port of ``test_prefill_decode_matches_
    forward``): prefill(8) + 4 decode steps equal the full teacher-forced
    forward at those positions, and the reference's prefill/decode (the
    frontend configs with their embeddings: whisper's encoder input, the
    early-fusion decoders' first 8 positions).  MoE runs dropless
    (capacity factor 64), as the reference's test does: a decode step's
    capacity is not the forward's."""
    jc, tc, pj, pt = _ref(*arch)
    if tc.moe:
        jc = dataclasses.replace(jc, moe_capacity_factor=64.0)
        tc = dataclasses.replace(tc, moe_capacity_factor=64.0)
    toks = _tokens(jc.vocab, (2, 16))
    fj, ft = _pair(_frontend(jc, 2))
    with torch.inference_mode():
        full, _ = tforward(pt, torch.from_numpy(toks).long(), tc,
                           frontend_embeds=ft)
        lt, ct = tprefill(pt, torch.from_numpy(toks[:, :8]).long(), tc, 32,
                          frontend_embeds=ft)
    lj, cj = jprefill(pj, jnp.asarray(toks[:, :8]), jc, s_max=32,
                      frontend_embeds=fj)
    torch.testing.assert_close(lt, full[:, 7], **TOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for t in range(8, 12):
        with torch.inference_mode():
            lt, ct = tdecode(pt, torch.from_numpy(toks[:, t]).long(), ct, tc)
        lj, cj = jdecode(pj, jnp.asarray(toks[:, t]), cj, jc)
        torch.testing.assert_close(lt, full[:, t], **TOL)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert ct.pos.tolist() == [12, 12]
    # the caches agree leaf for leaf (KV tensors, SSM and LRU states,
    # whisper's cross keys and values)
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        (cj.layers, cj.cross_kv))]
    tl = leaves((ct.layers, ct.cross_kv))
    assert (ct.cross_kv is not None) == tc.is_encdec
    assert [tuple(t.shape) for t in tl] == [x.shape for x in jl]
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.numpy(), b, **TOL)


def _stream_cases(archs):
    """Every backend on ``archs`` but the dense configs, which ride along
    on ``digital`` and ``bpbs``."""
    return [(a, b) for a in archs
            for b in (("digital", "bpbs") if a in DENSE
                      else ("digital", "bpbs", "kernel"))]


@pytest.mark.parametrize("arch,backend", _stream_cases(HERE),
                         ids=lambda v: v if isinstance(v, str) else _id(v))
def test_greedy_streams_equal_reference(arch, backend):
    """``Engine.generate`` in both packages; the frontend configs with
    their embeddings (an early-fusion prompt of 12: 8 embedded positions,
    then 4 tokens)."""
    jc, tc, pj, pt = _ref(*arch)
    jc, tc = _cfgs(jc, tc, backend)
    toks = _tokens(jc.vocab, (2, 12 if jc.frontend != "none" else 8))
    fj, ft = _pair(_frontend(jc, 2))
    je = JEngine(pj, jc, JServe(max_seq=32, max_new_tokens=6))
    te = TEngine(pt, tc, TServe(max_seq=32, max_new_tokens=6), device="cpu")
    assert (te.program is not None) == (backend != "digital")
    gj = np.asarray(je.generate(jnp.asarray(toks), fj))
    gt = te.generate(torch.from_numpy(toks), frontend_embeds=ft)
    np.testing.assert_array_equal(gt, gj)


_MEASURED = dict(sparsity=None, planes_skipped=None, planes_total=None)


@pytest.mark.parametrize("arch", RECURRENT[:2], ids=_id)
def test_program_tags_and_trace_match_reference(arch):
    """``build_program`` installs images on the reference's projections
    (``rec.in_x``/``in_gate``/``out`` and ``ssm.in_proj``/``out_proj``,
    never the digital ``w_rg``/``w_ig`` gates; MLA's ``dkv``/``krope``/
    ``ukv``, the stacked experts and the shared experts, never the
    router), and a traced prefill records the same calls per tag, every
    one served by an image.  The expert records are one per projection
    and layer, scaled by the experts as the reference's ``vmap`` is, with
    no measured sparsity; ``energy_summary`` with the measured fields
    cleared equals the reference's (its stacked layers run in a
    ``lax.scan`` and measure none)."""
    jc, tc, pj, pt = _ref(*arch)
    jc, tc = _cfgs(jc, tc, "kernel")
    jp = jaccel.build_program(pj, jc)
    tp = taccel.build_program(pt, tc)
    tags = sorted(i.tag for i in tp.images.values())
    assert tags == sorted(i.tag for i in jp.images.values())
    assert sorted(tp.images) == sorted(jp.images)
    assert tp.summary() == jp.summary()
    want = ({"ssm.in_proj", "ssm.out_proj"} if tc.family == "ssm" else
            {"attn.q", "attn.dkv", "attn.krope", "attn.ukv", "attn.o",
             "mlp.gate", "mlp.up", "mlp.down", "moe.gate", "moe.up",
             "moe.down", "moe.shared.gate", "moe.shared.up",
             "moe.shared.down"} if tc.moe else
            {"rec.in_x", "rec.in_gate", "rec.out", "attn.q", "attn.k",
             "attn.v", "attn.o", "mlp.gate", "mlp.up", "mlp.down"})
    assert set(tags) == want | {"unembed"}
    pj = jaccel.install_program(pj, jp, jc)
    pt = taccel.install_program(pt, tp, tc)
    toks = _tokens(jc.vocab, (2, 8))
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
    assert all(r.program for r in tt)
    per_layer = ({"attn": 8, "moe": 11} if tc.mla else
                 {"ssm": 2, "rec": 6, "attn": 7})
    assert len(tt) == sum(per_layer[k] for k in tc.pattern()) + 1
    if not tc.moe:
        return
    experts = [r for r in tt if r.tag in ("moe.gate", "moe.up", "moe.down")]
    cap = 5             # round(16 tokens x 2 / 8 experts x 1.25)
    assert len(experts) == 3 * tc.pattern().count("moe")
    assert all(r.copies == tc.n_experts and r.sparsity is None
               and r.calls == cap * tc.n_experts for r in experts)
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


@pytest.mark.parametrize("name", ["mamba2-130m", "recurrentgemma-9b"])
def test_long_context_archs_have_bounded_state(name):
    """The port of ``test_long_context_archs_have_bounded_state``: decode
    state bytes at s_max 4096 against 128, the same figure as the
    reference's caches."""
    tc, jc = tget(name).reduced(), jget(name).reduced()

    def nbytes(c):
        return sum(t.numel() * t.element_size() for t in leaves(c.layers))

    small = tinit_cache(tc, 1, 128, device="cpu")
    large = tinit_cache(tc, 1, 4096, device="cpu")
    assert nbytes(large) <= nbytes(small) * (1 if name == "mamba2-130m"
                                             else 64)
    if name == "mamba2-130m":
        assert nbytes(large) == nbytes(small)
    for s_max in (128, 4096):
        jb = sum(x.size * x.dtype.itemsize for x in
                 jax.tree_util.tree_leaves(jinit_cache(jc, 1, s_max).layers))
        assert nbytes(tinit_cache(tc, 1, s_max, device="cpu")) == jb


def test_windowed_ring_cache_matches_full():
    """recurrentgemma's ring cache (window 2048 -> reduced 64): a 90-token
    prefill into s_max 256 (the ring wraps) and 6 decode steps equal the
    full forward, in the port and against the reference's forward."""
    jc, tc, pj, pt = _ref("recurrentgemma-9b")
    assert tc.attn_window == 64
    toks = _tokens(jc.vocab, (1, 96), seed=3)
    lj, _ = jforward(pj, jnp.asarray(toks), jc)
    with torch.inference_mode():
        full, _ = tforward(pt, torch.from_numpy(toks).long(), tc)
        lt, cache = tprefill(pt, torch.from_numpy(toks[:, :90]).long(), tc,
                             s_max=256)
    np.testing.assert_allclose(full.numpy(), np.asarray(lj), **TOL)
    assert cache.layers["scanned"]["u2"].k.shape[2] == 64
    torch.testing.assert_close(lt, full[:, 89], **TOL)
    for t in range(90, 96):
        with torch.inference_mode():
            lt, cache = tdecode(pt, torch.from_numpy(toks[:, t]).long(),
                                cache, tc)
        torch.testing.assert_close(lt, full[:, t], **TOL)


def test_loss_and_gradient_step_mamba2():
    """The port of ``test_smoke_train_step`` on reduced mamba2: the loss
    allclose to the reference's, finite gradients allclose to
    ``jax.grad``'s, the loss near ln(vocab), and a finite loss after one
    SGD step."""
    jc, tc, pj, pt = _ref("mamba2-130m")
    toks = _tokens(jc.vocab, (2, 16))
    (lj, mj), gj = jax.value_and_grad(jloss, has_aux=True)(
        pj, {"tokens": jnp.asarray(toks)}, jc)
    ps = [t.clone().requires_grad_() for t in leaves(pt)]
    params = unflatten(pt, ps)
    batch = {"tokens": torch.from_numpy(toks).long()}
    lt, mt = tloss(params, batch, tc)
    grads = torch.autograd.grad(lt, ps)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    assert 0.5 * np.log(tc.vocab) < float(mt["ce"]) < 2.5 * np.log(tc.vocab)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    for g, h in zip(grads, jax.tree_util.tree_leaves(gj)):
        np.testing.assert_allclose(g.numpy(), np.asarray(h), rtol=1e-3,
                                   atol=1e-5)
    with torch.no_grad():
        stepped = unflatten(pt, [t - 1e-3 * g for t, g in zip(ps, grads)])
        l2, _ = tloss(stepped, batch, tc)
    assert np.isfinite(float(l2))


@pytest.mark.parametrize("name", ["whisper-tiny"])
def test_grouped_training_on_bpbs_matches_reference(name):
    """The port of the slow sweep of ``test_smoke_train_step`` for the
    configs whose forward makes grouped quantizing calls (MoE experts,
    whisper's cross k/v over its decoder layers), on ``bpbs``: the loss
    and every gradient allclose to ``jax.value_and_grad(loss_fn)``
    through the reference's ``vmap`` of its straight-through matmul, and
    a finite loss after one SGD step."""
    jc, tc = _cfgs(*_ref(name)[:2], "bpbs")
    pj, pt = _ref(name)[2:]
    toks = _tokens(jc.vocab, (2, 16))
    fj, ft = _pair(_frontend(jc, 2))
    bj = {"tokens": jnp.asarray(toks)}
    bt = {"tokens": torch.from_numpy(toks).long()}
    if fj is not None:
        bj["frontend_embeds"], bt["frontend_embeds"] = fj, ft
    (lj, _), gj = jax.value_and_grad(jloss, has_aux=True)(pj, bj, jc)
    ps = [t.clone().requires_grad_() for t in leaves(pt)]
    lt, _ = tloss(unflatten(pt, ps), bt, tc)
    grads = torch.autograd.grad(lt, ps)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    for (path, _), g, h in zip(leaves_with_path(pt), grads,
                               jax.tree_util.tree_leaves(gj)):
        assert bool(torch.isfinite(g).all()), path
        np.testing.assert_allclose(g.numpy(), np.asarray(h), rtol=1e-3,
                                   atol=1e-5, err_msg=path)
    with torch.no_grad():
        stepped = unflatten(pt, [t - 1e-3 * g for t, g in zip(ps, grads)])
        l2, _ = tloss(stepped, bt, tc)
    assert np.isfinite(float(l2))


def test_prefill_resume_refuses_encdec():
    """A chunked prefill of an encoder-decoder model is refused, as the
    reference refuses it (its encoder runs whole in ``prefill``)."""
    jc, tc, pj, pt = _ref("whisper-tiny")
    with torch.inference_mode():
        _, cache = tprefill(pt, torch.zeros(1, 4, dtype=torch.long), tc, 16)
        with pytest.raises(NotImplementedError, match="encoder-decoder"):
            tresume(pt, torch.zeros(1, 2, dtype=torch.long), tc, cache)
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        jresume(pj, jnp.zeros((1, 2), jnp.int32), jc, None)
