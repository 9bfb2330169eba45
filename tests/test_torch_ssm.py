"""The port's recurrent mixers against the JAX package's, piece by piece:
the causal conv, the SSD segment sums and chunked scan (``models.ssm``),
the RG-LRU scan (``models.rglru``), and both mixers whole on the decode
and the sequence path.

Same numpy inputs and the reference's own parameters (its ``init_ssm`` /
``init_rglru`` converted by ``params_from_jax``), float32, reduced widths.
The causal conv sums its k shifted products left to right in both
packages and agrees bitwise; everything else is float32 arithmetic in
another order (torch's pairwise einsums and cumsum against XLA's, and a
doubling scan against ``lax.associative_scan``), held ``allclose`` at
atol/rtol 1e-5 for the pieces and 1e-4 for the mixers, as the port's
other float logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import rglru as jrg
from repro.models import ssm as jssm
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.models import rglru as trg
from repro_torch.models import ssm as tssm

TOL = dict(rtol=1e-4, atol=1e-4)
PIECE = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_bitwise(with_state):
    r = _rng(1)
    x = r.normal(size=(2, 7, 12)).astype(np.float32)
    w = r.normal(size=(4, 12)).astype(np.float32)
    b = r.normal(size=(12,)).astype(np.float32)
    st = r.normal(size=(2, 3, 12)).astype(np.float32) if with_state else None
    yj, sj = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               None if st is None else jnp.asarray(st))
    yt, s_t = tssm._causal_conv(_t(x), _t(w), _t(b),
                                None if st is None else _t(st))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(sj))


def test_segsum_matches_reference():
    dA = -np.abs(_rng(2).normal(size=(2, 3, 16))).astype(np.float32)
    lj = np.asarray(jssm._segsum(jnp.asarray(dA)))
    lt = tssm._segsum(_t(dA)).numpy()
    np.testing.assert_array_equal(np.isinf(lt), np.isinf(lj))
    fin = np.isfinite(lj)
    np.testing.assert_allclose(lt[fin], lj[fin], **PIECE)


@pytest.mark.parametrize("s", [5, 16, 37])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(s, with_state):
    """One partial chunk, exactly one chunk and three chunks with a
    padded tail; with and without a carried ``init_state``."""
    r = _rng(s)
    b, h, p, n, chunk = 2, 3, 4, 5, 16
    x = r.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.abs(r.normal(size=(b, s, h))).astype(np.float32) * 0.1
    A = np.log(np.arange(1, h + 1)).astype(np.float32)
    B_ = r.normal(size=(b, s, n)).astype(np.float32)
    C_ = r.normal(size=(b, s, n)).astype(np.float32)
    init = (r.normal(size=(b, h, p, n)).astype(np.float32) if with_state
            else None)
    yj, fj = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, B_, C_)), chunk,
                              init_state=None if init is None
                              else jnp.asarray(init))
    yt, ft = tssm.ssd_chunked(*map(_t, (x, dt, A, B_, C_)), chunk,
                              init_state=None if init is None else _t(init))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **PIECE)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **PIECE)


@pytest.mark.parametrize("s", [1, 2, 7, 64, 100])
def test_lru_scan_matches_associative_scan(s):
    """The doubling scan against ``lax.associative_scan``: both
    reassociate the products, so allclose, not bitwise; and against the
    plain sequential recurrence."""
    r = _rng(s)
    a = r.uniform(0.5, 1.0, size=(2, s, 6)).astype(np.float32)
    b = r.normal(size=(2, s, 6)).astype(np.float32)
    hj = np.asarray(jrg._lru_scan(jnp.asarray(a), jnp.asarray(b)))
    ht = trg._lru_scan(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(ht, hj, **PIECE)
    h = np.zeros((2, 6), np.float32)
    seq = []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        seq.append(h)
    np.testing.assert_allclose(ht, np.stack(seq, 1), **PIECE)


def _mixer(kind):
    """The reference's mixer params (converted) at reduced width."""
    name = "mamba2-130m" if kind == "ssm" else "recurrentgemma-9b"
    jc, tc = jget(name).reduced(), tget(name).reduced()
    init = jssm.init_ssm if kind == "ssm" else jrg.init_rglru
    pj = init(jax.random.PRNGKey(3), jc)
    pt = params_from_jax(jax.tree.map(np.asarray, pj), "cpu")
    return jc, tc, pj, pt


def _run(kind, pkg, params, x, cfg, state, decode, pad_mask=None):
    if pkg == "jax":
        fn = jssm.ssm_forward if kind == "ssm" else jrg.rglru_forward
        return fn(params, jnp.asarray(x), cfg, state, decode, jnp.float32,
                  pad_mask=None if pad_mask is None
                  else jnp.asarray(pad_mask))
    fn = tssm.ssm_forward if kind == "ssm" else trg.rglru_forward
    with torch.inference_mode():
        return fn(params, _t(x), cfg, state, decode, torch.float32,
                  pad_mask=None if pad_mask is None else _t(pad_mask))


def _state(kind, pkg, cfg, batch, r):
    """A random carried state in each package (the same numbers)."""
    if kind == "ssm":
        d_inner, h, conv_dim = jssm.dims(cfg)
        conv = r.normal(size=(batch, cfg.conv1d_size - 1, conv_dim))
        st = r.normal(size=(batch, h, cfg.ssm_head_dim, cfg.ssm_state))
        cls = jssm.SSMState if pkg == "jax" else tssm.SSMState
    else:
        conv = r.normal(size=(batch, cfg.conv1d_size - 1, cfg.lru_width))
        st = r.normal(size=(batch, cfg.lru_width))
        cls = jrg.LRUState if pkg == "jax" else trg.LRUState
    conv, st = conv.astype(np.float32), st.astype(np.float32)
    wrap = jnp.asarray if pkg == "jax" else _t
    return cls(wrap(conv), wrap(st))


@pytest.mark.parametrize("path", ["sequence", "resume", "decode", "padded"])
@pytest.mark.parametrize("kind", ["ssm", "rec"])
def test_mixer_matches_reference(kind, path):
    """Each mixer whole: a fresh sequence, a sequence resumed from a
    carried state (``ssd_chunked(init_state=)`` / the ``h0`` fold-in), a
    single decode step from a carried state, and a left-padded sequence
    under ``pad_mask``; output and new state allclose."""
    jc, tc, pj, pt = _mixer(kind)
    r = _rng(5)
    s = 1 if path == "decode" else 21
    x = r.normal(size=(2, s, jc.d_model)).astype(np.float32)
    mask = None
    if path == "padded":
        mask = np.ones((2, s), bool)
        mask[0, :6] = False
    carried = path in ("resume", "decode")
    js = _state(kind, "jax", jc, 2, _rng(6)) if carried else None
    ts = _state(kind, "torch", tc, 2, _rng(6)) if carried else None
    yj, nj = _run(kind, "jax", pj, x, jc, js, path == "decode", mask)
    yt, nt = _run(kind, "torch", pt, x, tc, ts, path == "decode", mask)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    for a, b in zip(nt, nj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("kind", ["ssm", "rec"])
def test_padded_mixer_state_equals_unpadded(kind):
    """Left pads are identity steps: the state after a padded row equals
    the state after its real tokens alone, in the port.  The conv bias is
    drawn nonzero (at init it is 0, and zeroed pad inputs would then
    leave a zero state whether or not the steps were identities), so a
    pad step's own activations are nonzero and only the identity
    transitions keep them out of the state."""
    _, tc, _, pt = _mixer(kind)
    pt = dict(pt, conv_b=_t(_rng(9).normal(size=tuple(pt["conv_b"].shape))
                            .astype(np.float32)))
    x = _rng(7).normal(size=(1, 9, tc.d_model)).astype(np.float32)
    padded = np.concatenate([np.zeros((1, 4, tc.d_model), np.float32), x], 1)
    mask = np.zeros((1, 13), bool)
    mask[0, 4:] = True
    y0, s0 = _run(kind, "torch", pt, x, tc, None, False)
    y1, s1 = _run(kind, "torch", pt, padded, tc, None, False, mask)
    torch.testing.assert_close(y1[:, 4:], y0, **TOL)
    for a, b in zip(s1, s0):
        torch.testing.assert_close(a, b, **TOL)


def test_unfused_gate_equals_fused_in_float32():
    """``fuse_datapath=False`` applies the gate GELU after the
    projection; in float32 on ``digital`` the two agree."""
    _, tc, _, pt = _mixer("rec")
    x = _rng(8).normal(size=(2, 5, tc.d_model)).astype(np.float32)
    y0, _ = _run("rec", "torch", pt, x, tc, None, False)
    y1, _ = _run("rec", "torch", pt, x,
                 dataclasses.replace(tc, fuse_datapath=False), None, False)
    torch.testing.assert_close(y0, y1, rtol=0, atol=0)
