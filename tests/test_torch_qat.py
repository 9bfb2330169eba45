"""Quantization-aware training in the port against the JAX package.

The straight-through ``accel.matmul`` (``dx``, ``dw`` and the epilogue
registers' gradients against ``jax.grad``, unfused and with a fused
``post``), ``saturate``'s gradient on its bounds, ``fake_quant``, and
three QAT steps (``train.cifar_qat.qat_update``) of reduced CIFAR
Networks A and B against the reference's ``examples/train_cifar_qat.py``
update.  The port's ``kernel`` backend runs its plain torch version on
CPU tensors and answers to the reference's Pallas kernel in interpret
mode (``pallas``); ``digital_int`` and ``bpbs`` answer to their
namesakes.

Tolerances:

* STE forward outputs: equal to the reference's within rtol 1e-6 (the
  integer grids are shared exactly; the rescale may round once more).
  Gradients: rtol 1e-5 and atol 1e-5 x the largest magnitude: the
  backward is float32 GEMMs summed in another order (XLA vs torch).
* ``saturate`` and the B_y bound through ``accel.matmul``: exact — a
  value on a bound gets gradient 1/2 (``jnp.clip``'s rule), in both
  packages.
* ``fake_quant``: forward bitwise, gradient exactly the identity.
* QAT steps: see :func:`test_qat_steps_match_reference`.  XLA's and
  torch's reductions and ``rsqrt`` differ by ulps in train-mode batch
  norm, which is why the BN affine parameters start from seeded
  non-trivial values there (:func:`_qat_setup` says why), and why
  Network B (signs of sums of ±1) is held step by step along the
  reference's trajectory: an ulp that flips one sign changes every later
  step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import accel as jaccel
from repro.configs import NETWORK_A as JNET_A
from repro.configs import NETWORK_B as JNET_B
from repro.core.datapath import Postreduce as JPost
from repro.core.datapath import saturate as jsaturate
from repro.data.pipeline import DataConfig as JData
from repro.data.pipeline import make_batch as jbatch
from repro.models import cnn as jcnn
from repro.optim import qat as jqat
from repro.optim.adamw import AdamWConfig as JAdam
from repro.optim.adamw import apply_updates as japply
from repro.optim.adamw import init_opt_state as jinit_opt
from repro_torch import accel as taccel
from repro_torch.configs import NETWORK_A as TNET_A
from repro_torch.configs import NETWORK_B as TNET_B
from repro_torch.convert import params_from_jax
from repro_torch.core.datapath import Postreduce as TPost
from repro_torch.core.datapath import saturate as tsaturate
from repro_torch.data.pipeline import DataConfig as TData
from repro_torch.data.pipeline import make_batch as tbatch
from repro_torch.optim import qat as tqat
from repro_torch.optim.adamw import AdamWConfig as TAdam
from repro_torch.optim.adamw import init_opt_state as tinit_opt
from repro_torch.train.cifar_qat import fig11_accuracy, qat_update
from repro_torch.tree import leaves

JAX_NAME = {"digital_int": "digital_int", "bpbs": "bpbs",
            "kernel": "pallas"}
GRAD_RTOL = 1e-5

rng = np.random.default_rng(0)
X = rng.normal(size=(8, 300)).astype(np.float32)
W = rng.normal(size=(300, 48)).astype(np.float32)
SCALE = rng.normal(size=(48,)).astype(np.float32)
BIAS = rng.normal(size=(48,)).astype(np.float32)
RES = rng.normal(size=(8, 48)).astype(np.float32)
R = rng.normal(size=(8, 48)).astype(np.float32)     # upstream gradient


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _close(got, want, rtol=GRAD_RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _post(mod, variant, arrays):
    """(Postreduce, names of its differentiable registers)."""
    s, b, res = arrays
    if variant == "none":
        return None, ()
    if variant == "residual":
        return mod(bias=res), ("bias",)
    return mod(scale=s, bias=b, act=variant, saturate=True), ("scale", "bias")


def _ste_grads(backend, variant):
    """(reference (y, grads), port (y, grads)) of sum(matmul(...) * R)
    over x, w and the post registers."""
    spec_j = jaccel.ExecSpec(backend=JAX_NAME[backend], ba=4, bx=4,
                             bank_n=128)
    spec_t = taccel.ExecSpec(backend=backend, ba=4, bx=4, bank_n=128)
    _, regs = _post(JPost, variant, (SCALE, BIAS, RES))

    def f(x, w, s, b, res):
        post, _ = _post(JPost, variant, (s, b, res))
        y = jaccel.matmul(x, w, spec_j, post=post)
        return jnp.sum(y * R), y

    (_, yj), gj = jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4),
                                     has_aux=True)(
        *(jnp.asarray(a) for a in (X, W, SCALE, BIAS, RES)))
    want = {"x": gj[0], "w": gj[1]}
    want.update({"scale": gj[2], "bias": gj[4 if variant == "residual"
                                             else 3]})
    ts = [torch.tensor(a, requires_grad=True)
          for a in (X, W, SCALE, BIAS, RES)]
    post, _ = _post(TPost, variant, ts[2:])
    yt = taccel.matmul(ts[0], ts[1], spec_t, post=post)
    (yt * torch.from_numpy(R)).sum().backward()
    got = {"x": ts[0].grad, "w": ts[1].grad, "scale": ts[2].grad,
           "bias": ts[4 if variant == "residual" else 3].grad}
    keys = ("x", "w") + regs
    return (np.asarray(yj), {k: np.asarray(want[k]) for k in keys}), \
        (yt.detach().numpy(), {k: got[k].numpy() for k in keys})


@pytest.mark.parametrize("variant", ["none", "relu", "gelu", "silu",
                                     "identity", "residual"])
@pytest.mark.parametrize("backend", ["digital_int", "bpbs", "kernel"])
def test_ste_gradients_match_jax_grad(backend, variant):
    (yj, want), (yt, got) = _ste_grads(backend, variant)
    _close(yt, yj, rtol=1e-6)
    assert set(got) == set(want)
    for k in want:
        assert np.abs(want[k]).max() > 0, k
        _close(got[k], want[k])


@pytest.mark.parametrize("backend", ["digital_int", "bpbs", "kernel"])
def test_ste_gradient_parity_through_fused_epilogue(backend):
    """d(fused)/d{x, w, scale, bias} == d(postreduce(matmul))/d{...}:
    STE through the quantized matmul, true gradient through the epilogue
    (port of ``test_datapath_fusion.py``'s test), bitwise."""
    spec = taccel.ExecSpec(backend=backend, ba=4, bx=4, bank_n=128)

    def grads(fused):
        ts = [torch.tensor(a, requires_grad=True)
              for a in (X, W, SCALE, BIAS)]
        post = TPost(scale=ts[2], bias=ts[3], act="gelu", saturate=True)
        y = (taccel.matmul(ts[0], ts[1], spec, post=post) if fused
             else post.apply(taccel.matmul(ts[0], ts[1], spec), spec.bx,
                             spec.ba))
        y.sum().backward()
        return [t.grad for t in ts]

    for a, b in zip(grads(True), grads(False)):
        assert torch.equal(a, b)


def test_no_grad_and_inference_keep_the_fused_path(monkeypatch):
    """Without autograd the kernel backend runs the epilogue fused (one
    call with the registers); under autograd it runs unfused, as the
    reference differentiates it."""
    from repro_torch.kernels import ops

    seen = []
    real = ops.cima_mvm

    def spy(*a, **kw):
        seen.append(kw.get("act"))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "cima_mvm", spy)
    spec = taccel.ExecSpec(backend="kernel", ba=4, bx=4, bank_n=128)
    x, w = torch.from_numpy(X), torch.tensor(W, requires_grad=True)
    post = TPost(scale=torch.from_numpy(SCALE), act="relu")
    with torch.inference_mode():
        y_inf = taccel.matmul(x, w, spec, post=post)
    with torch.no_grad():
        y_ng = taccel.matmul(x, w, spec, post=post)
    y_grad = taccel.matmul(x, w, spec, post=post)
    assert seen == ["relu", "relu", None]
    assert torch.equal(y_inf, y_ng)
    torch.testing.assert_close(y_grad.detach(), y_ng, rtol=1e-6, atol=1e-6)


def test_saturate_gradient_on_the_bounds_is_one_half():
    v = np.array([-9.0, -8.0, -7.5, 0.0, 7.0, 7.5, 8.0], np.float32)
    want = np.asarray(jax.grad(lambda y: jnp.sum(jsaturate(y, 4)))(
        jnp.asarray(v)))
    np.testing.assert_array_equal(want, [0, .5, 1, 1, .5, 0, 0])
    t = torch.tensor(v, requires_grad=True)
    out = tsaturate(t, 4)
    out.sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), want)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(jsaturate(jnp.asarray(v), 4)))
    with torch.no_grad():          # the serving path: clamp, same values
        assert torch.equal(tsaturate(torch.from_numpy(v), 4), out.detach())


@pytest.mark.parametrize("backend", ["digital_int", "kernel"])
def test_by_bound_ties_through_matmul(backend):
    """Outputs put exactly on the B_y bound (a residual on the bias port
    lands them there) take half the upstream gradient, in both packages:
    operands on the 4-bit XNOR grid with scale 1 make every product
    exact."""
    r = np.random.default_rng(3)
    x = 2.0 * r.integers(-4, 5, (6, 40)).astype(np.float32)
    w = 2.0 * r.integers(-4, 5, (40, 12)).astype(np.float32)
    x[:, 0], w[0, :] = 8.0, 8.0         # every scale exactly 1
    spec_t = taccel.ExecSpec(backend=backend, ba=4, bx=4, x_per_row=True,
                             ideal_adc=True)
    spec_j = jaccel.ExecSpec(backend=JAX_NAME[backend], ba=4, bx=4,
                             x_per_row=True, ideal_adc=True)
    with torch.no_grad():
        y = taccel.matmul(torch.from_numpy(x), torch.from_numpy(w), spec_t)
    y = y.numpy()
    np.testing.assert_array_equal(y, x @ w)
    bits, hi = 16, 2.0 ** 15 - 1
    tie = r.random(y.shape) < 0.3
    res = np.where(tie, np.where(r.random(y.shape) < 0.5, hi, -hi - 1) - y,
                   0.0).astype(np.float32)
    upstream = r.normal(size=y.shape).astype(np.float32)

    def f(xx, ww, b):
        out = jaccel.matmul(xx, ww, spec_j, post=JPost(bias=b,
                                                       by_bits=bits))
        return jnp.sum(out * upstream), out

    (_, out_j), (gx, gw, gb) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(res))
    ts = [torch.tensor(a, requires_grad=True) for a in (x, w, res)]
    out_t = taccel.matmul(ts[0], ts[1], spec_t,
                          post=TPost(bias=ts[2], by_bits=bits))
    (out_t * torch.from_numpy(upstream)).sum().backward()
    on_bound = np.isin(out_t.detach().numpy(), (hi, -hi - 1))
    np.testing.assert_array_equal(on_bound, tie)
    np.testing.assert_array_equal(out_t.detach().numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(ts[2].grad.numpy(), np.asarray(gb))
    np.testing.assert_array_equal(ts[2].grad.numpy()[tie],
                                  0.5 * upstream[tie])
    _close(ts[0].grad.numpy(), gx)
    _close(ts[1].grad.numpy(), gw)


@pytest.mark.parametrize("bits,axis", [(4, None), (2, None), (4, 1)])
def test_fake_quant_forward_bitwise_gradient_identity(bits, axis):
    v = np.random.default_rng(bits).normal(size=(6, 10)).astype(np.float32)
    want = np.asarray(jqat.fake_quant(jnp.asarray(v), bits, axis=axis))
    t = torch.tensor(v, requires_grad=True)
    out = tqat.fake_quant(t, bits, axis=axis)
    np.testing.assert_array_equal(out.detach().numpy(), want)
    up = torch.randn(6, 10)
    (out * up).sum().backward()
    assert torch.equal(t.grad, up)


# ------------------------------------------------ QAT of the CIFAR networks

NETS = {"a": (JNET_A, TNET_A), "b": (JNET_B, TNET_B)}
QAT_STEPS = 3


def _jax_update(net, opt_cfg):
    """The reference example's ``update`` (noiseless)."""
    @jax.jit
    def update(params, opt, batch):
        (loss, m), grads = jax.value_and_grad(
            lambda p: jcnn.cnn_loss(p, batch, net), has_aux=True)(params)
        params, opt, om = japply(params, grads, opt, opt_cfg)
        params = jcnn.update_bn_stats(params, m.pop("bn_stats"))
        return params, opt, {**m, **om}, grads

    return update


def _qat_setup(name):
    """Reduced nets, the reference's ``init_cnn`` parameters with seeded
    non-trivial BN affine parameters (scale 1 + N(0, 0.1), bias
    N(0, 0.2)), and the converted port tree.  With bias 0 the relu/sign
    threshold sits exactly on the batch mean, and a quantized channel's
    outputs land on it whenever the mean lands on a grid level: there
    an ulp of either package's mean decides the mask."""
    jn, tn = (n.reduced() for n in NETS[name])
    r = np.random.default_rng(5)
    pj = {"layers": [
        dict(q, bn_scale=jnp.asarray(
                 1 + 0.1 * r.normal(size=q["bn_scale"].shape), jnp.float32),
             bn_bias=jnp.asarray(0.2 * r.normal(size=q["bn_bias"].shape),
                                 jnp.float32))
        for q in jcnn.init_cnn(jax.random.PRNGKey(0), jn)["layers"]]}
    return jn, tn, pj


def _to_port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


@pytest.mark.parametrize("name", ["a", "b"])
def test_qat_steps_match_reference(name):
    """Three QAT steps along the reference's trajectory: before each step
    the port takes the reference's parameters and AdamW state, then both
    step on the same batch.  Gradients within rtol 1e-4 of each leaf's
    largest magnitude (float32 sums through nine layers in another
    order); losses, gradient norms and the learning rate within rtol 1e-5, accuracies equal, every parameter and running
    statistic within rtol 1e-5 of the leaf's largest magnitude plus a
    quarter of the step's learning rate: AdamW's normalized update of a
    gradient element that cancels to near zero (Network B's FC layers sum
    ±1 inputs) takes its size from the summation order.  Network A
    (relu, no sign) also runs the three steps on its own state, within
    rtol 5e-5 of each leaf's largest magnitude."""
    from repro_torch.models.cnn import cnn_loss
    from repro_torch.optim.adamw import OptState
    from repro_torch.train.step import value_and_grad

    jn, tn, pj = _qat_setup(name)
    kw = dict(lr=1e-3, warmup_steps=5, total_steps=QAT_STEPS,
              weight_decay=0.0)
    upd = _jax_update(jn, JAdam(**kw))
    oj = jinit_opt(pj)
    pt_free, ot_free = _to_port(pj), tinit_opt(_to_port(pj))
    dj = JData(kind="cifar_synthetic", global_batch=8, seed=1)
    dt = TData(kind="cifar_synthetic", global_batch=8, seed=1)
    for step in range(QAT_STEPS):
        bj, bt = jbatch(dj, step), tbatch(dt, step, "cpu")
        pt, ot = _to_port(pj), OptState(*_to_port(tuple(oj)))
        _, gt = value_and_grad(lambda p: cnn_loss(p, bt, tn), pt)
        pj, oj, mj, gj = upd(pj, oj, bj)
        for a, b in zip(leaves(gt), jax.tree_util.tree_leaves(gj)):
            _close(a.numpy(), b, rtol=1e-4)
        pt, ot, mt = qat_update(pt, ot, bt, tn, TAdam(**kw))
        for k in ("loss", "grad_norm", "lr"):
            _close(float(mt[k]), float(mj[k]))
        assert float(mt["acc"]) == float(mj["acc"])
        slack = 0.25 * float(mj["lr"])
        for a, b in zip(leaves(pt), jax.tree_util.tree_leaves(pj)):
            b = np.asarray(b)
            np.testing.assert_allclose(
                a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max() + slack)
        assert int(ot.count) == int(oj.count) == step + 1
        if name == "a":
            pt_free, ot_free, m_free = qat_update(pt_free, ot_free, bt, tn,
                                                  TAdam(**kw))
            _close(float(m_free["loss"]), float(mj["loss"]), rtol=5e-5)
            for a, b in zip(leaves(pt_free), jax.tree_util.tree_leaves(pj)):
                _close(a.numpy(), b, rtol=5e-5)


def test_qat_gradients_reach_every_trained_leaf():
    """One QAT step of reduced Network B: the weights and BN affine
    parameters move, the running statistics take no gradient (they move
    by the EMA alone) and Fig. 11's accuracy runs under every backend."""
    from repro_torch.models.cnn import cnn_loss, init_cnn
    from repro_torch.train.step import value_and_grad

    net = TNET_B.reduced()
    p = init_cnn(0, net, device="cpu")
    batch = tbatch(TData(kind="cifar_synthetic", global_batch=8, seed=1), 0,
                   "cpu")
    (loss, m), g = value_and_grad(lambda q: cnn_loss(q, batch, net), p)
    assert np.isfinite(float(loss))
    for layer in g["layers"]:
        assert float(layer["w"].abs().max()) > 0
        assert float(layer["bn_scale"].abs().max()) > 0
        assert float(layer["bn_mean"].abs().max()) == 0.0
    p2, _, _ = qat_update(p, tinit_opt(p), batch, net,
                          TAdam(lr=1e-3, warmup_steps=1, weight_decay=0.0))
    mu = m["bn_stats"][0][0]
    torch.testing.assert_close(p2["layers"][0]["bn_mean"], 0.1 * mu,
                               rtol=1e-6, atol=1e-7)
    for backend in ("kernel", "digital_int", "digital"):
        acc = fig11_accuracy(p2, [batch], net, backend)
        assert 0.0 <= acc <= 1.0
