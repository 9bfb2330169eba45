"""The paper's CIFAR networks in the port against the JAX package.

``NETWORK_A.reduced()`` and ``NETWORK_B.reduced()`` with the reference's
``init_cnn`` parameters converted key for key, and non-trivial BN running
statistics from one reference ``train=True`` forward and
``update_bn_stats``.  Inputs are seeded numpy images.

Tolerances: ``_im2col`` is a copy and must be bitwise equal.  One layer
on the same input gives a fused epilogue within rtol 1e-6: the folded
BN scale ``gamma * rsqrt(var + eps)`` may differ by one float32 ulp (XLA's
rsqrt and torch's round differently).  Over the whole net those ulps can
move a requantized activation by one grid step, so logits are held at
rtol 1e-4 of their largest magnitude with identical argmax, and Network
B's hidden activations (signs) must be identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import accel as jaccel
from repro.configs import NETWORK_A as JNET_A
from repro.configs import NETWORK_B as JNET_B
from repro.core.datapath import Postreduce as JPost
from repro.core.datapath import fold_batchnorm as jfold
from repro.models import cnn as jcnn
from repro_torch import accel as taccel
from repro_torch.configs import NETWORK_A as TNET_A
from repro_torch.configs import NETWORK_B as TNET_B
from repro_torch.convert import params_from_jax
from repro_torch.core.datapath import Postreduce as TPost
from repro_torch.core.datapath import fold_batchnorm as tfold
from repro_torch.models import cnn as tcnn
from repro_torch.optim.qat import ste_sign

NETS = {"a": (JNET_A, TNET_A), "b": (JNET_B, TNET_B)}
# port backend -> the reference backend it answers to on the CPU
JAX_NAME = {"digital": "digital", "digital_int": "digital_int",
            "bpbs": "bpbs", "kernel": "bpbs"}
RECORD_FIELDS = ("tag", "backend", "n", "m", "ba", "bx", "calls", "program",
                 "loads", "post_ops", "sparsity", "planes_skipped",
                 "planes_total", "copies")


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module", params=["a", "b"])
def net(request):
    """(reference config, port config, reference params, port params,
    images [4, 32, 32, 3])."""
    jn, tn = (n.reduced() for n in NETS[request.param])
    pj = jcnn.init_cnn(jax.random.PRNGKey(0), jn)
    r = np.random.default_rng(1)
    train = r.normal(size=(8, 32, 32, 3)).astype(np.float32)
    _, stats = jax.jit(lambda p, x: jcnn.cnn_forward(
        p, x, jn, backend="digital", train=True))(pj, jnp.asarray(train))
    pj = jcnn.update_bn_stats(pj, stats)
    pt = params_from_jax(jax.tree.map(np.asarray, pj), "cpu")
    images = r.normal(size=(4, 32, 32, 3)).astype(np.float32)
    return request.param, jn, tn, pj, pt, images


def test_im2col_bitwise_equal_and_spatial_major():
    r = np.random.default_rng(0)
    for shape in ((2, 5, 5, 3), (3, 8, 8, 16), (1, 4, 4, 7)):
        x = r.normal(size=shape).astype(np.float32)
        t = tcnn._im2col(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(t, np.asarray(jcnn._im2col(
            jnp.asarray(x))))
        xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
        np.testing.assert_array_equal(t[0, 1, 2],
                                      xp[0, 1:4, 2:5, :].reshape(-1))


def test_converted_params_carry_the_layer_list(net):
    _, jn, _, pj, pt, _ = net
    assert isinstance(pt["layers"], list) and len(pt["layers"]) == len(
        jn.layers)
    for p, q in zip(pt["layers"], pj["layers"]):
        assert set(p) == set(q) == {"w", "bn_scale", "bn_bias", "bn_mean",
                                    "bn_var"}
        for k in p:
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(q[k]))
    fresh = tcnn.init_cnn(0, NETS[net[0]][1].reduced(), device="cpu")
    assert [{k: tuple(v.shape) for k, v in p.items()}
            for p in fresh["layers"]] == \
        [{k: tuple(v.shape) for k, v in p.items()} for p in pt["layers"]]
    np.testing.assert_array_equal(fresh["layers"][0]["bn_var"].numpy(), 1.0)


@pytest.mark.parametrize("backend", ["digital", "digital_int", "bpbs",
                                     "kernel"])
def test_eval_logits_match_reference(net, backend):
    _, jn, tn, pj, pt, images = net
    want = np.asarray(jax.jit(lambda p, x: jcnn.cnn_forward(
        p, x, jn, backend=JAX_NAME[backend]))(pj, jnp.asarray(images)))
    got = tcnn.cnn_forward(pt, torch.from_numpy(images), tn,
                           backend=backend).numpy()
    assert got.shape == (4, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_kernel_matches_the_pallas_kernel_in_interpret_mode():
    """The port's kernel backend (plain version on CPU tensors) against
    the reference's Pallas kernel, interpret mode, one image of reduced
    Network B (every layer on the kernel)."""
    jn, tn = JNET_B.reduced(), TNET_B.reduced()
    pj = jcnn.init_cnn(jax.random.PRNGKey(2), jn)
    pt = params_from_jax(jax.tree.map(np.asarray, pj), "cpu")
    x = np.random.default_rng(2).normal(size=(1, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda p, x: jcnn.cnn_forward(
        p, x, jn, backend="pallas"))(pj, jnp.asarray(x)))
    got = tcnn.cnn_forward(pt, torch.from_numpy(x), tn).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _layer_chain(mod, acc, post_cls, fold, params, images, net, backend,
                 feed=None):
    """cnn_forward's eval loop, layer by layer: the outputs after each
    layer (pooled), and with ``feed`` (the other package's outputs) each
    layer's output on the other package's input instead."""
    outs, fed = [], []
    x = images
    n_layers = len(net.layers)
    for i, (layer, p) in enumerate(zip(net.layers, params["layers"])):
        spec = dataclasses.replace(
            net.policy.resolve(f"layer{i}", kind=layer.kind, layer=i),
            backend=backend)
        s, b = fold(p["bn_scale"], p["bn_bias"], p["bn_mean"], p["bn_var"])
        post = post_cls(scale=s, bias=b, saturate=True,
                        act=None if i == n_layers - 1 else
                        ("sign" if net.readout == "abn" else "relu"))

        def run(x):
            h = mod._im2col(x) if layer.kind == "conv" else \
                x.reshape(x.shape[0], -1)
            y = acc.matmul(h, p["w"], spec, post=post)
            if layer.kind == "conv" and layer.pool:
                b_, hh, ww, c = y.shape
                y = y.reshape(b_, hh // 2, 2, ww // 2, 2, c)
                y = y.max(axis=(2, 4)) if mod is jcnn else \
                    y.amax(dim=(2, 4))
            return y

        if mod is jcnn:
            run = jax.jit(run)
        x = run(x)
        outs.append(x)
        if feed is not None:
            fed.append(run(torch.from_numpy(np.array(feed[i - 1]))
                           if i else images))
    return outs, fed


def test_per_layer_epilogue_and_hidden_activations(net):
    """Every layer on the kernel backend (its plain version here) against
    the reference's bpbs on the reference's own input: fused epilogue
    within rtol 1e-6.  Chained on their own outputs, Network B's hidden
    sign activations are identical, and the port's chain is its
    cnn_forward bit for bit."""
    name, jn, tn, pj, pt, images = net
    jouts, _ = _layer_chain(jcnn, jaccel, JPost, jfold, pj,
                            jnp.asarray(images), jn, "bpbs")
    jouts = [np.asarray(o) for o in jouts]
    touts, fed = _layer_chain(tcnn, taccel, TPost, tfold, pt,
                              torch.from_numpy(images), tn, "kernel",
                              feed=jouts)
    for i, (f, want) in enumerate(zip(fed, jouts)):
        np.testing.assert_allclose(f.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=f"layer {i}")
    if name == "b":
        for i in range(len(jouts) - 1):
            np.testing.assert_array_equal(touts[i].numpy(), jouts[i],
                                          err_msg=f"hidden layer {i}")
            assert set(np.unique(jouts[i])) <= {-1.0, 1.0}
    logits = tcnn.cnn_forward(pt, torch.from_numpy(images), tn)
    assert torch.equal(logits, touts[-1])


def test_eval_logits_batch_independent(net):
    """A single image's logits are the same alone and inside a batch
    (running statistics folded into the datapath), on the float path and
    on the kernel backend with per-row input scales; the train=True
    forward (live batch statistics) is batch dependent."""
    _, _, tn, _, pt, images = net
    x = torch.from_numpy(images)
    alone = tcnn.cnn_forward(pt, x[:1], tn, backend="digital")
    batch = tcnn.cnn_forward(pt, x, tn, backend="digital")
    torch.testing.assert_close(alone[0], batch[0], rtol=1e-5, atol=1e-6)
    with taccel.override(x_per_row=True):
        alone = tcnn.cnn_forward(pt, x[:1], tn)
        batch = tcnn.cnn_forward(pt, x, tn)
    torch.testing.assert_close(alone[0], batch[0], rtol=1e-5, atol=1e-6)
    alone_t, _ = tcnn.cnn_forward(pt, x[:1], tn, backend="digital",
                                  train=True)
    batch_t, _ = tcnn.cnn_forward(pt, x, tn, backend="digital", train=True)
    assert float((alone_t[0] - batch_t[0]).abs().max()) > 1e-3


def test_eval_runs_fused_datapath_train_does_not():
    net = TNET_B.reduced()
    params = tcnn.init_cnn(0, net, device="cpu")
    imgs = torch.randn(2, 32, 32, 3, generator=torch.Generator()
                       .manual_seed(0))
    with taccel.trace() as recs:
        tcnn.cnn_forward(params, imgs, net)
    assert len(recs) == 9 and all(r.post_ops >= 3 for r in recs)
    assert all(r.backend == "kernel" for r in recs)
    with taccel.trace() as recs_t:
        tcnn.cnn_forward(params, imgs, net, train=True)
    assert len(recs_t) == 9 and all(r.post_ops == 0 for r in recs_t)


@pytest.mark.parametrize("backend", ["digital", "bpbs"])
def test_train_forward_and_bn_stats_match_reference(backend):
    """Network A's train=True forward, its batch statistics and the EMA
    update against the reference (rtol 1e-4 of the largest magnitude:
    live-statistics BN in another summation order)."""
    jn, tn = JNET_A.reduced(), TNET_A.reduced()
    pj = jcnn.init_cnn(jax.random.PRNGKey(3), jn)
    pt = params_from_jax(jax.tree.map(np.asarray, pj), "cpu")
    x = np.random.default_rng(3).normal(size=(4, 32, 32, 3)).astype(
        np.float32)
    batch = {"images": x, "labels": np.array([0, 1, 2, 3], np.int32)}
    (lj, mj) = jax.jit(lambda p, b: jcnn.cnn_loss(p, b, jn, backend))(
        pj, jax.tree.map(jnp.asarray, batch))
    lt, mt = tcnn.cnn_loss(pt, {k: torch.from_numpy(v)
                                for k, v in batch.items()}, tn, backend)
    assert float(lt) == pytest.approx(float(lj), rel=1e-5)
    assert float(mt["acc"]) == float(mj["acc"])
    for (tm, tv), (jm, jv) in zip(mt["bn_stats"], mj["bn_stats"]):
        for a, b in ((tm, jm), (tv, jv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-4 * float(np.abs(b).max()))
    pj2 = jcnn.update_bn_stats(pj, mj["bn_stats"], momentum=0.5)
    pt2 = tcnn.update_bn_stats(pt, mt["bn_stats"], momentum=0.5)
    for p, q in zip(pt2["layers"], pj2["layers"]):
        for k in ("bn_mean", "bn_var"):
            np.testing.assert_allclose(p[k].numpy(), np.asarray(q[k]),
                                       rtol=1e-4, atol=1e-6)
    assert all(p["w"] is q["w"] for p, q in zip(pt2["layers"],
                                                pt["layers"]))


def test_train_pieces_of_network_b_match_reference():
    """Network B's train=True pieces on the same inputs: live-statistics
    BN and the straight-through sign.  (Chained over the whole net, ±1
    activations put batch values exactly on the batch mean, where a one-ulp
    difference of the mean flips a sign; the pieces are held instead.)"""
    r = np.random.default_rng(4)
    y = r.normal(size=(2, 8, 8, 16)).astype(np.float32)
    g = r.uniform(0.5, 1.5, 16).astype(np.float32)
    b = r.normal(size=16).astype(np.float32)
    oj, (mj, vj) = jcnn._batchnorm(jnp.asarray(y), jnp.asarray(g),
                                   jnp.asarray(b))
    ot, (mt, vt) = tcnn._batchnorm(torch.from_numpy(y), torch.from_numpy(g),
                                   torch.from_numpy(b))
    for a, c in ((ot, oj), (mt, mj), (vt, vj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-5,
                                   atol=1e-6)
    from repro.optim.qat import ste_sign as jsign

    z = np.array([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 1.5], np.float32)
    zt = torch.tensor(z, requires_grad=True)
    out = ste_sign(zt)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(jsign(jnp.asarray(z))))
    out.backward(torch.arange(1.0, 8.0))
    gj = jax.grad(lambda v: jnp.sum(jsign(v) * jnp.arange(1.0, 8.0)))(
        jnp.asarray(z))
    np.testing.assert_array_equal(zt.grad.numpy(), np.asarray(gj))


def test_traced_cost_equals_reference(net):
    """The CNN loop is unrolled and eager in both packages: a traced
    forward gives equal records (measured sparsity and all-zero planes
    included) and an equal energy_summary at both corners and readouts.
    Both run digital_int, so both measure the same activations."""
    _, jn, tn, pj, pt, images = net
    x = images[:2]
    with jaccel.trace(vdd=0.85) as jr:
        jcnn.cnn_forward(pj, jnp.asarray(x), jn, backend="digital_int")
    with taccel.trace(vdd=0.85) as tr:
        tcnn.cnn_forward(pt, torch.from_numpy(x), tn, backend="digital_int")
    assert len(tr) == len(jr) == 9
    for t, j in zip(tr, jr):
        assert {f: getattr(t, f) for f in RECORD_FIELDS} == \
            {f: getattr(j, f) for f in RECORD_FIELDS}
        assert t.sparsity is not None and t.planes_total
    assert taccel.energy_summary(tr) == jaccel.energy_summary(jr)
    for vdd in (0.85, 1.2):
        for readout in ("adc", "abn"):
            assert taccel.energy_summary(tr, vdd=vdd, readout=readout) == \
                jaccel.energy_summary(jr, vdd=vdd, readout=readout)
