"""The port's mixture-of-experts FFN and its grouped dispatch against the
JAX package.

``moe_ffn`` runs on reduced deepseek-v2-lite-16b (8 experts, top-2, 2
shared) and reduced llama4-scout-17b-a16e (8 experts, top-1, 1 shared;
its vision frontend set to ``"none"``, the MoE block alone), with the
reference's ``init_moe`` converted key for key and the same numpy inputs
in float32: outputs ``allclose`` at atol/rtol 1e-4, the aux loss at rtol
1e-6, the routing identical, at the default capacity factor (where
assignments drop) and at 64.0 (where none do), on ``digital_int``,
``bpbs`` and ``kernel`` (the plain version; the reference runs
``pallas`` in interpret mode).

The grouped ``accel.matmul`` (``w`` [G, N, M], the reference's
``jax.vmap`` over the experts) must equal a loop of 2-D dispatches over
the groups bit for bit on every backend, and the grouped plain kernel
each group's 2-D plain kernel.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import accel as jaccel
from repro.configs import get_config as jget
from repro.models.layers import linear as jlinear
from repro.models.moe import init_moe as jinit_moe
from repro.models.moe import moe_ffn as jmoe_ffn
from repro_torch import accel as taccel
from repro_torch.accel import program as tprogram
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.core.bpbs import BpbsConfig
from repro_torch.core.datapath import Postreduce
from repro_torch.core.quant import Coding
from repro_torch.kernels import cima_mvm as K
from repro_torch.models import moe as tmoe

JAX_NAME = {"digital_int": "digital_int", "bpbs": "bpbs", "kernel": "pallas"}
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["deepseek-v2-lite-16b", "llama4-scout-17b-a16e"]
RECORD_FIELDS = ("tag", "n", "m", "ba", "bx", "calls", "program", "loads",
                 "load_segments", "post_ops", "sparsity", "planes_skipped",
                 "planes_total", "copies")


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _cfgs(arch, backend, capacity=None):
    kw = {"frontend": "none", "frontend_seq": 0} \
        if jget(arch).frontend != "none" else {}
    if capacity is not None:
        kw["moe_capacity_factor"] = capacity
    jc = dataclasses.replace(jget(arch).reduced(), **kw)
    tc = dataclasses.replace(tget(arch).reduced(), **kw)
    return (jc.with_accel(JAX_NAME[backend], ba=4, bx=4),
            tc.with_accel(backend, ba=4, bx=4))


def _moe_params(jc, seed=1):
    pj = jinit_moe(jax.random.PRNGKey(seed), jc)
    return pj, params_from_jax(jax.tree.map(np.asarray, pj), "cpu")


def _jroute(pj, xt, jc):
    logits = jlinear(pj["router"], xt, None, jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    return jax.lax.top_k(probs, jc.experts_per_tok)


@pytest.mark.parametrize("capacity", [None, 64.0], ids=["default", "64"])
@pytest.mark.parametrize("backend", ["digital_int", "bpbs", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, backend, capacity):
    jc, tc = _cfgs(arch, backend, capacity)
    pj, pt = _moe_params(jc)
    x = np.random.default_rng(0).normal(size=(2, 8, jc.d_model)).astype(
        np.float32)
    yj, aj = jmoe_ffn(pj, jnp.asarray(x), jc, dtype=jnp.float32)
    with torch.inference_mode():
        yt, at = tmoe.moe_ffn(pt, torch.from_numpy(x), tc,
                              dtype=torch.float32)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)
    xt = x.reshape(-1, jc.d_model)
    jw, jidx = _jroute(pj, jnp.asarray(xt), jc)
    _, tw, tidx = tmoe.route(pt, torch.from_numpy(xt), tc)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(
        tw.numpy(), np.asarray(jw / jnp.maximum(jw.sum(-1, keepdims=True),
                                                1e-9)), rtol=1e-6)
    # the default capacity drops assignments here; 64.0 drops none
    t = xt.shape[0]
    per_expert = np.bincount(tidx.numpy().ravel(), minlength=tc.n_experts)
    assert tmoe.capacity(t, tc) == int(min(
        t * tc.experts_per_tok, max(1, round(t * tc.experts_per_tok
                                             / tc.n_experts
                                             * tc.moe_capacity_factor))))
    assert (per_expert.max() > tmoe.capacity(t, tc)) == (capacity is None)


@pytest.mark.parametrize("arch", ARCHS)
def test_exact_router_ties_pick_the_lower_expert(arch):
    """Equal router probabilities: ``jax.lax.top_k`` takes the lower
    index first, and so does the port (a stable descending sort)."""
    jc, tc = _cfgs(arch, "digital_int")
    pj, pt = _moe_params(jc)
    k, e = tc.experts_per_tok, tc.n_experts
    w = np.zeros((jc.d_model, e), np.float32)
    w[:, 3] = w[:, 6] = 1.0          # experts 3 and 6 tie at the top
    w[:, 1] = 0.5
    pj = dict(pj, router={"w": jnp.asarray(w)})
    pt = dict(pt, router={"w": torch.from_numpy(w)})
    xt = np.abs(np.random.default_rng(2).normal(
        size=(4, jc.d_model))).astype(np.float32)
    _, jidx = _jroute(pj, jnp.asarray(xt), jc)
    _, _, tidx = tmoe.route(pt, torch.from_numpy(xt), tc)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert tidx[:, 0].tolist() == [3] * 4
    if k > 1:
        assert tidx[:, 1].tolist() == [6] * 4
    # all-equal logits: the first k experts, in order
    zero = dict(pt, router={"w": torch.zeros((jc.d_model, e))})
    _, _, tidx = tmoe.route(zero, torch.from_numpy(xt), tc)
    assert tidx.tolist() == [list(range(k))] * 4


# --------------------------------------------------------- grouped dispatch

def _grouped_operands(g=3, c=5, n=300, m=24, seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(g, c, n)).astype(np.float32)
    x[0, 1, :50] = 0.0                       # some input sparsity
    x[g - 1] = 0.0                           # an expert no token reached
    w = (r.normal(size=(g, n, m)) * n ** -0.5).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


@pytest.mark.parametrize("backend", ["digital", "digital_int", "bpbs",
                                     "bpbs_ref", "kernel"])
def test_grouped_matmul_equals_looped_dispatch(backend):
    """One grouped dispatch against a loop of 2-D dispatches over the
    groups, bit for bit: per-tensor and per-row input scales, 4-bit and
    1-bit grids, with and without an image and the fused SiLU."""
    x, w = _grouped_operands()
    bits = [(4, 4)] + ([(1, 1)] if backend != "bpbs_ref" else [])
    for (ba, bx) in bits:
        for per_row in (False, True):
            spec = taccel.ExecSpec(backend=backend, ba=ba, bx=bx,
                                   bank_n=256, x_per_row=per_row)
            img = (tprogram._compile_image(w, spec, "w")
                   if backend != "digital" else None)
            for image in ((None, img) if img is not None else (None,)):
                for post in (None, Postreduce(act="silu")):
                    got = taccel.matmul(x, w, spec, image=image, post=post)
                    want = torch.stack([taccel.matmul(
                        x[g], w[g], spec, post=post,
                        image=image.layer(g) if image is not None else None)
                        for g in range(w.shape[0])])
                    assert got.shape == (3, 5, 24)
                    assert torch.equal(got, want), (ba, per_row, post)


@pytest.mark.parametrize("post", [None, "act"])
@pytest.mark.parametrize("backend", ["digital_int", "bpbs", "kernel"])
def test_grouped_matmul_matches_reference_vmap(backend, post):
    """The grouped dispatch against ``jax.vmap`` of the reference's
    dispatch (``pallas`` in interpret mode for the kernel), inside
    ``vmapped(G)``: equal outputs (bitwise without the epilogue, rtol 1e-6
    with the fused SiLU) and equal trace records."""
    x, w = _grouped_operands(seed=1)
    kw = dict(ba=4, bx=4, bank_n=256, tag="moe.gate")
    js = jaccel.ExecSpec(backend=JAX_NAME[backend], **kw)
    ts = taccel.ExecSpec(backend=backend, **kw)
    from repro.core.datapath import Postreduce as JPost
    jpost = JPost(act="silu") if post else None
    tpost = Postreduce(act="silu") if post else None
    with jaccel.trace() as jt, jaccel.vmapped(3):
        yj = jax.vmap(lambda a, b: jaccel.matmul(a, b, js, post=jpost))(
            jnp.asarray(x.numpy()), jnp.asarray(w.numpy()))
    with taccel.trace() as tt, taccel.vmapped(3):
        yt = taccel.matmul(x, w, ts, post=tpost)
    if post is None:
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    else:
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-6,
                                   atol=1e-6)
    assert len(tt) == len(jt) == 1
    assert {f: getattr(tt[0], f) for f in RECORD_FIELDS} == \
        {f: getattr(jt[0], f) for f in RECORD_FIELDS}
    assert tt[0].calls == 3 * 5 and tt[0].copies == 3
    assert tt[0].sparsity is None


def _grouped_grads(backend, post_kind, x, w, r, loop=False):
    """(y, grads of x, w and the shared post's scale and bias) of
    sum(matmul(x, w) * r) through the port's grouped dispatch, or, with
    ``loop``, through a loop of 2-D dispatches over the groups."""
    spec = taccel.ExecSpec(backend=backend, ba=4, bx=4, bank_n=256)
    m = w.shape[-1]
    rng = np.random.default_rng(7)
    ts = [x.clone().requires_grad_(), w.clone().requires_grad_(),
          torch.tensor(rng.normal(size=(m,)).astype(np.float32),
                       requires_grad=True),
          torch.tensor(rng.normal(size=(m,)).astype(np.float32),
                       requires_grad=True)]
    post = (None if post_kind is None else
            Postreduce(scale=ts[2], bias=ts[3], act="silu", saturate=True))
    if loop:
        y = torch.stack([taccel.matmul(ts[0][g], ts[1][g], spec, post=post)
                         for g in range(w.shape[0])])
    else:
        y = taccel.matmul(ts[0], ts[1], spec, post=post)
    (y * r).sum().backward()
    grads = {"x": ts[0].grad, "w": ts[1].grad}
    if post is not None:
        grads.update(scale=ts[2].grad, bias=ts[3].grad)
    return y.detach(), grads, post, spec


@pytest.mark.parametrize("post", [None, "fused"])
@pytest.mark.parametrize("backend", ["kernel", "bpbs", "bpbs_ref"])
def test_grouped_matmul_under_autograd(backend, post):
    """The grouped straight-through backward: gradients of x, w and the
    shared epilogue's scale and bias allclose to a loop of 2-D
    straight-through calls (the same float GEMMs, summed in another
    order) and to ``jax.grad`` through the reference's ``vmap`` within
    rtol 1e-5.  The forward under autograd is the no-grad grouped call
    followed by the epilogue, bitwise, and so the no-grad call itself
    without an epilogue; with the epilogue fused into the kernel (its
    rescale folded into the scale registers) within rtol 1e-6, as on
    the 2-D path."""
    x, w = _grouped_operands(c=4, n=300, m=24, seed=3)
    r = torch.from_numpy(np.random.default_rng(4).normal(
        size=(3, 4, 24)).astype(np.float32))
    y, got, tpost, spec = _grouped_grads(backend, post, x, w, r)
    _, loop, _, _ = _grouped_grads(backend, post, x, w, r, loop=True)
    with torch.no_grad():
        bare = taccel.matmul(x, w, spec)
        fused = taccel.matmul(x, w, spec, post=tpost)
    assert torch.equal(y, bare if tpost is None
                       else tpost.apply(bare, spec.bx, spec.ba))
    if backend == "kernel" and tpost is not None:
        # the kernel folds the rescale into its scale registers, as the
        # 2-D path does: fused and unfused differ in the last place
        torch.testing.assert_close(y, fused, rtol=1e-6, atol=1e-6)
    else:
        assert torch.equal(y, fused)
    assert set(got) == set(loop) == ({"x", "w"} if post is None
                                     else {"x", "w", "scale", "bias"})
    for k in got:
        assert got[k].abs().max() > 0, k
        torch.testing.assert_close(got[k], loop[k], rtol=1e-6, atol=1e-6)

    js = jaccel.ExecSpec(backend=JAX_NAME.get(backend, backend), ba=4, bx=4,
                         bank_n=256)
    from repro.core.datapath import Postreduce as JPost

    def f(xj, wj, s, b):
        p = None if post is None else JPost(scale=s, bias=b, act="silu",
                                             saturate=True)
        yj = jax.vmap(lambda a, c: jaccel.matmul(a, c, js, post=p))(xj, wj)
        return jnp.sum(yj * jnp.asarray(r.numpy()))

    gj = jax.grad(f, argnums=(0, 1, 2, 3))(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
        *(jnp.asarray(tpost.scale.detach().numpy()) if tpost else None,
          jnp.asarray(tpost.bias.detach().numpy()) if tpost else None))
    want = dict(zip(("x", "w", "scale", "bias"), gj))
    for k in got:
        ref = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


def test_grouped_digital_matmul_under_autograd():
    """A digital grouped call differentiates natively: the loop's
    gradients, bitwise."""
    x, w = _grouped_operands(c=2, n=64, m=8)
    spec = taccel.ExecSpec(backend="digital")
    xa = x.clone().requires_grad_()
    taccel.matmul(xa, w, spec).square().sum().backward()
    xb = x.clone().requires_grad_()
    torch.stack([taccel.matmul(xb[g], w[g], spec) for g in range(3)]
                ).square().sum().backward()
    assert torch.equal(xa.grad, xb.grad)


def _int_operands(g, rows, n, m, cfg, seed=0):
    r = np.random.default_rng(seed)
    x = 2 * r.integers(-4, 5, (g, rows, n)) * (r.random((g, rows, n)) > 0.3)
    w = 2 * r.integers(-4, 5, (g, n, m))
    xs, nu, lead = K.prepare_inputs(torch.tensor(x, dtype=torch.float32), cfg,
                                    grouped=True)
    ws, fs = K.prepare_weights(torch.tensor(w, dtype=torch.float32), cfg)
    return xs, ws, nu, fs, lead


@pytest.mark.parametrize("rows", [1, 5, 15])
def test_grouped_plain_kernel_equals_each_group(rows):
    """The grouped plain version, one batch of torch ops, against the 2-D
    plain version group by group: bitwise, over a ragged last bank (2,400
    = 2,304 + 96 rows), unfused and with the fused SiLU and per-row,
    per-group and shared scale registers; ``prepare_inputs`` counts each
    group's own rows."""
    cfg = BpbsConfig(ba=4, bx=4, coding=Coding.XNOR)
    g, n, m = 4, 2400, 40
    xs, ws, nu, fs, lead = _int_operands(g, rows, n, m, cfg)
    assert lead == (rows,) and tuple(xs.shape) == (g, rows, 4, n)
    assert tuple(nu.shape) == (g, rows, 2) and tuple(ws.shape) == (g, n, 4, m)
    gen = torch.Generator().manual_seed(rows)
    regs = [(None, None, None),
            (torch.rand(g, rows, m, generator=gen) * 1e-3,
             torch.randn(m, generator=gen), "silu"),
            (torch.rand(g, 1, m, generator=gen) * 1e-3, None, "silu"),
            (torch.rand(m, generator=gen) * 1e-3,
             torch.randn(g, 1, m, generator=gen), None)]
    for es, pb, act in regs:
        y = K.cima_mvm_planes_reference(xs, ws, nu, fs, cfg, es, pb, act)
        assert tuple(y.shape) == (g, rows, m)
        assert torch.equal(y, K.cima_mvm_planes(xs, ws, nu, fs, cfg, es, pb,
                                                act))
        for i in range(g):
            def one(v):
                return v[i] if v is not None and v.ndim == 3 else v
            yi = K.cima_mvm_planes_reference(xs[i], ws[i], nu[i], fs, cfg,
                                             one(es), one(pb), act)
            assert torch.equal(y[i], yi), (i, act)


def test_grouped_prepare_inputs_counts_each_group():
    cfg = BpbsConfig(ba=4, bx=4, bank_n=128)
    r = np.random.default_rng(3)
    x = torch.tensor(2 * r.integers(-4, 5, (3, 2, 6, 300))
                     * (r.random((3, 2, 6, 300)) > 0.5), dtype=torch.float32)
    xs, nu, lead = K.prepare_inputs(x, cfg, grouped=True)
    assert lead == (2, 6) and tuple(xs.shape) == (3, 12, 4, 300)
    for i in range(3):
        xi, nui, _ = K.prepare_inputs(x[i], cfg)
        assert torch.equal(xs[i], xi) and torch.equal(nu[i], nui)


@pytest.mark.parametrize("bad", ["groups", "nu_groups", "too_many", "es"])
def test_grouped_wrapper_rejects_mismatched_groups(bad):
    cfg = BpbsConfig(ba=4, bx=4)
    xs, ws, nu, fs, _ = _int_operands(3, 2, 64, 16, cfg)
    if bad == "groups":
        ws = ws[:2].contiguous()
    elif bad == "nu_groups":
        nu = nu[:1].contiguous()
    elif bad == "too_many":
        g = K.MAX_GROUPS + 1
        xs = torch.empty((g,) + xs.shape[1:], dtype=torch.int8,
                         device="meta")
        ws = torch.empty((g,) + ws.shape[1:], dtype=torch.int8,
                         device="meta")
        nu = torch.empty((g,) + nu.shape[1:], device="meta")
        fs = fs.to("meta")
    if bad == "es":
        with pytest.raises(ValueError, match="epilogue operand"):
            K._epilogue_operand(torch.ones(2, 1, 16), 2, 16, "cpu", 3)
        return
    with pytest.raises(ValueError, match="groups"):
        K._check_launch(xs, ws, nu, fs, cfg, None)


def test_launch_shape_counts_every_group():
    """A grouped decode launch (64 experts of 1,408 columns, one row) has
    enough blocks to fill the card without splitting banks; one group of
    the same shape splits them over a cluster of 4."""
    cfg = BpbsConfig(ba=4, bx=4)
    assert K.launch_shape(1, 2048, 1408, cfg, 132, 64) == (1, 4, 1)
    assert K.launch_shape(1, 2048, 1408, cfg, 132) == (1, 4, 4)
