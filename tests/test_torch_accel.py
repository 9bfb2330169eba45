"""The port's accel layer against the JAX package's.

Backends ``digital_int``/``bpbs``/``kernel`` are held to the reference's
``digital_int``/``bpbs``/``pallas`` on the same numpy inputs, with and
without a compiled weight image.  Without an epilogue the port computes
the same integer grids and the same multiplications, so the outputs are
bitwise equal.  With one, XLA on the CPU may contract the bias add into a
fused multiply-add and ``silu`` rounds ``exp`` differently: rtol 1e-6.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import accel as jaccel
from repro.accel import program as jprogram
from repro.core.datapath import Postreduce as JPost
from repro_torch import accel as taccel
from repro_torch.accel import program as tprogram
from repro_torch.core.datapath import Postreduce as TPost

JAX_NAME = {"digital_int": "digital_int", "bpbs": "bpbs", "kernel": "pallas"}


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _operands(seed=0, b=3, n=300, m=24):
    r = np.random.default_rng(seed)
    x = r.normal(size=(b, 2, n)).astype(np.float32)
    x[0, 0, :40] = 0.0                        # some input sparsity
    w = (r.normal(size=(n, m)) * n ** -0.5).astype(np.float32)
    res = r.normal(size=(b, 2, m)).astype(np.float32)
    return x, w, res


def _posts(kind, res):
    if kind is None:
        return None, None
    if kind == "act":
        return JPost(act="silu"), TPost(act="silu")
    if kind == "colbias":
        bias = np.linspace(-1, 1, res.shape[-1]).astype(np.float32)
        return (JPost(bias=jnp.asarray(bias), saturate=True),
                TPost(bias=torch.from_numpy(bias), saturate=True))
    return JPost(bias=jnp.asarray(res)), TPost(bias=torch.from_numpy(res))


@pytest.mark.parametrize("post", [None, "act", "colbias", "residual"])
@pytest.mark.parametrize("image", [False, True])
@pytest.mark.parametrize("backend", ["digital_int", "bpbs", "kernel"])
def test_backend_matches_reference(backend, image, post):
    x, w, res = _operands()
    kw = dict(ba=4, bx=4, bank_n=256, x_per_row=True)
    js = jaccel.ExecSpec(backend=JAX_NAME[backend], **kw)
    ts = taccel.ExecSpec(backend=backend, **kw)
    jimg = jprogram._compile_image(jnp.asarray(w), js, "w") if image else None
    timg = (tprogram._compile_image(torch.from_numpy(w), ts, "w")
            if image else None)
    jpost, tpost = _posts(post, res)
    yj = jaccel.matmul(jnp.asarray(x), jnp.asarray(w), js, image=jimg,
                       post=jpost)
    yt = taccel.matmul(torch.from_numpy(x), torch.from_numpy(w), ts,
                       image=timg, post=tpost)
    if post is None:
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    else:
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("post", [None, "act", "residual"])
@pytest.mark.parametrize("backend", ["digital_int", "bpbs", "kernel"])
def test_program_path_equals_on_the_fly_bitwise(backend, post):
    x, w, res = _operands(1)
    ts = taccel.ExecSpec(backend=backend, ba=3, bx=4, bank_n=128)
    img = tprogram._compile_image(torch.from_numpy(w), ts, "w")
    _, tpost = _posts(post, res)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    with taccel.trace() as tr:
        a = taccel.matmul(xt, wt, ts, image=img, post=tpost)
        b = taccel.matmul(xt, wt, ts, post=tpost)
    assert torch.equal(a, b)
    assert [r.program for r in tr] == [True, False]


def test_stacked_image_layers_equal_single_images():
    w = torch.randn(3, 64, 16, generator=torch.Generator().manual_seed(0))
    ts = taccel.ExecSpec(backend="bpbs", ba=2, bx=2)
    stacked = tprogram._compile_image(w, ts, "w")
    assert stacked.copies == 3 and tuple(stacked.ws.shape) == (3, 64, 2, 16)
    for i in range(3):
        one = tprogram._compile_image(w[i], ts, "w")
        layer = stacked.layer(i)
        for f in ("ws", "wq", "scale"):
            assert torch.equal(getattr(layer, f), getattr(one, f))


@pytest.mark.parametrize("post", [None, "act"])
@pytest.mark.parametrize("backend", ["digital", "digital_int", "bpbs",
                                     "kernel"])
def test_trace_record_matches_reference(backend, post):
    x, w, res = _operands(2)
    jname = {"digital": "digital", **JAX_NAME}[backend]
    js = jaccel.ExecSpec(backend=jname, ba=2, bx=3, tag="mlp.up")
    ts = taccel.ExecSpec(backend=backend, ba=2, bx=3, tag="mlp.up")
    jpost, tpost = _posts(post, res)
    with jaccel.trace() as jt:
        jaccel.matmul(jnp.asarray(x), jnp.asarray(w), js, post=jpost)
    with taccel.trace() as tt:
        taccel.matmul(torch.from_numpy(x), torch.from_numpy(w), ts,
                      post=tpost)
    assert isinstance(tt, taccel.Trace)
    assert len(jt) == len(tt) == 1
    j, t = jt[0], tt[0]
    assert (t.tag, t.n, t.m, t.ba, t.bx, t.calls, t.program, t.post_ops) == \
        (j.tag, j.n, j.m, j.ba, j.bx, j.calls, j.program, j.post_ops)
    assert t.backend == backend and j.backend == jname


def test_override_keeps_image_across_backends_and_drops_it_on_ba():
    x, w, _ = _operands(3)
    ts = taccel.ExecSpec(backend="kernel", ba=4, bx=4)
    img = tprogram._compile_image(torch.from_numpy(w), ts, "w")
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    with taccel.trace() as tr:
        with taccel.override(backend="bpbs"):
            taccel.matmul(xt, wt, ts, image=img)
        with taccel.override(ba=2):
            taccel.matmul(xt, wt, ts, image=img)
        taccel.matmul(xt, wt, None)           # digital by design: no record
    assert [(r.backend, r.ba, r.program) for r in tr] == \
        [("bpbs", 4, True), ("kernel", 2, False)]
    with pytest.raises(TypeError):
        with taccel.override(nonsense=1):
            pass


def test_spec_rejects_unknown_backend():
    with pytest.raises(ValueError, match="unknown accel backend"):
        taccel.ExecSpec(backend="pallas")


@pytest.mark.parametrize("query", [("mlp.down", "mlp", None),
                                   ("attn.q", "attn", 2),
                                   ("unembed", "unembed", None),
                                   ("attn.o", "attn", 7)])
def test_policy_resolution_matches_reference(query):
    def policy(acc, name):
        return acc.PrecisionPolicy(
            rules=(("kind:mlp", acc.ExecSpec(backend="bpbs", ba=1, bx=1)),
                   ("path:unembed", acc.ExecSpec(backend="digital")),
                   ("layer:1-3", acc.ExecSpec(backend=name, ba=2, bx=2)),
                   ("path:attn.o", acc.ExecSpec(backend="digital_int"))),
            default=acc.ExecSpec(backend=name, ba=4, bx=4))

    path, kind, layer = query
    js = policy(jaccel, "pallas").resolve(path, kind, layer)
    ts = policy(taccel, "kernel").resolve(path, kind, layer)
    assert (ts.ba, ts.bx, ts.tag) == (js.ba, js.bx, js.tag)
    assert ts.backend == {"pallas": "kernel"}.get(js.backend, js.backend)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("backend", ["digital_int", "bpbs", "bpbs_ref",
                                     "kernel"])
def test_eight_bit_inputs_saturate_as_the_reference(backend, per_row):
    """At B_X = 8 the XNOR grid puts each scale's largest input on +128,
    one past int8: the reference's cast saturates it to 127, and so must
    the port's (a wrapping cast makes it -128 and moves the SQNR of an
    8-bit point from 33.4 to 17.2 dB), also in a grouped call."""
    r = np.random.default_rng(5)
    x = r.normal(size=(2, 4, 128)).astype(np.float32)
    x[:, :, 3] = np.abs(x).max() + 1.0          # every row's amax positive
    w = (r.normal(size=(2, 128, 16)) * 128 ** -0.5).astype(np.float32)
    kw = dict(ba=4, bx=8, x_per_row=per_row)
    js = jaccel.ExecSpec(backend=JAX_NAME.get(backend, backend), **kw)
    ts = taccel.ExecSpec(backend=backend, **kw)
    for g in range(2):
        yj = jaccel.matmul(jnp.asarray(x[g]), jnp.asarray(w[g]), js)
        yt = taccel.matmul(torch.from_numpy(x[g]), torch.from_numpy(w[g]),
                           ts)
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    yg = taccel.matmul(torch.from_numpy(x), torch.from_numpy(w), ts)
    yl = torch.stack([taccel.matmul(torch.from_numpy(x[g]),
                                    torch.from_numpy(w[g]), ts)
                      for g in range(2)])
    assert torch.equal(yg, yl)


def test_spec_with_and_policy_with_rule_match_reference():
    """``ExecSpec.with_`` and ``PrecisionPolicy.with_rule`` (prepended:
    first in its specificity class) resolve as the reference's."""
    def policy(acc, name):
        base = acc.PrecisionPolicy(
            rules=(("kind:mlp", acc.ExecSpec(backend=name, ba=2, bx=2)),),
            default=acc.ExecSpec(backend=name, ba=4, bx=4))
        spec = base.default.with_(ba=1, bx=1, skip_zero_planes=False)
        return base.with_rule("kind:mlp", spec).with_rule(
            "path:attn.*", spec.with_(ba=8))

    jp, tp = policy(jaccel, "pallas"), policy(taccel, "kernel")
    assert [p for p, _ in tp.rules] == [p for p, _ in jp.rules]
    for path, kind in (("mlp.up", "mlp"), ("attn.q", "attn"),
                       ("unembed", "unembed")):
        js, ts = jp.resolve(path, kind), tp.resolve(path, kind)
        assert (ts.ba, ts.bx, ts.skip_zero_planes, ts.tag) == \
            (js.ba, js.bx, js.skip_zero_planes, js.tag)


def test_config_registry_and_with_policy_match_reference():
    from repro.configs import list_archs as jlist
    from repro_torch.configs import get_config as tget
    from repro_torch.configs import list_archs as tlist

    assert tlist() == jlist()
    policy = taccel.PrecisionPolicy.uniform(
        taccel.ExecSpec(backend="bpbs", ba=2, bx=2))
    cfg = tget("olmo-1b").with_policy(policy)
    assert cfg.policy is policy
    assert cfg == dataclasses.replace(tget("olmo-1b"), policy=policy)


def test_digital_backend_computes_at_the_caller_dtype():
    x, w, _ = _operands(4)
    y = taccel.matmul(torch.from_numpy(x), torch.from_numpy(w),
                      taccel.ExecSpec(backend="digital"), dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16
