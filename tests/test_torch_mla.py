"""The port's Multi-head Latent Attention (deepseek-v2) against the JAX
package's ``mla_attention``.

Reduced deepseek-v2-lite-16b (4 heads, latent rank 32, nope/rope/v head
dims 32/16/32) with the reference's ``init_mla`` converted key for key
and the same numpy inputs in float32: a prefill without a cache, a
prefill into the latent cache followed by decode steps, a left-padded
prefill under ``pad_mask`` (cache written left-aligned) and a resumed
prefill at per-row positions.  Outputs and caches ``allclose`` at
atol/rtol 1e-4, on ``digital`` and ``bpbs``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import attention as jattn
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as tattn

TOL = dict(rtol=1e-4, atol=1e-4)
S_MAX = 16


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _setup(backend):
    jc = jget("deepseek-v2-lite-16b").reduced()
    tc = tget("deepseek-v2-lite-16b").reduced()
    if backend != "digital":
        jc, tc = (jc.with_accel(backend, ba=4, bx=4),
                  tc.with_accel(backend, ba=4, bx=4))
    pj = jattn.init_mla(jax.random.PRNGKey(3), jc)
    pt = params_from_jax(jax.tree.map(np.asarray, pj), "cpu")
    x = np.random.default_rng(0).normal(size=(2, 12, jc.d_model)).astype(
        np.float32)
    return jc, tc, pj, pt, x


def _run(fn_j, fn_t):
    oj, cj = fn_j()
    with torch.inference_mode():
        ot, ct = fn_t()
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
    if cj is not None:
        for a, b in zip(ct, cj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    return cj, ct


def _caches(jc, tc):
    return (jattn.init_mla_cache(jc, 2, S_MAX, jnp.float32),
            tattn.init_mla_cache(tc, 2, S_MAX, torch.float32, "cpu"))


@pytest.mark.parametrize("backend", ["digital", "bpbs"])
def test_mla_prefill_matches_reference(backend):
    jc, tc, pj, pt, x = _setup(backend)
    pos = np.arange(12)
    _run(lambda: jattn.mla_attention(pj, jnp.asarray(x), jc, jnp.asarray(pos),
                                     dtype=jnp.float32),
         lambda: tattn.mla_attention(pt, torch.from_numpy(x), tc,
                                     torch.from_numpy(pos),
                                     dtype=torch.float32))


@pytest.mark.parametrize("backend", ["digital", "bpbs"])
def test_mla_prefill_and_decode_match_reference(backend):
    """A prefill of 8 tokens into the latent cache, then 4 decode steps at
    per-row positions (rows 8 and 8; the whole cache expanded by
    ``w_ukv`` every step), caches written in place."""
    jc, tc, pj, pt, x = _setup(backend)
    cj, ct = _caches(jc, tc)
    pos = np.arange(8)
    cj, ct = _run(
        lambda: jattn.mla_attention(pj, jnp.asarray(x[:, :8]), jc,
                                    jnp.asarray(pos), cj, dtype=jnp.float32),
        lambda: tattn.mla_attention(pt, torch.from_numpy(x[:, :8]), tc,
                                    torch.from_numpy(pos), ct,
                                    dtype=torch.float32))
    for t in range(8, 12):
        cp = np.full((2,), t)
        cj, ct2 = _run(
            lambda: jattn.mla_attention(
                pj, jnp.asarray(x[:, t:t + 1]), jc, jnp.asarray(cp[:, None]),
                cj, jnp.asarray(cp), dtype=jnp.float32),
            lambda: tattn.mla_attention(
                pt, torch.from_numpy(x[:, t:t + 1]), tc,
                torch.from_numpy(cp[:, None]), ct, torch.from_numpy(cp),
                dtype=torch.float32))
        assert ct2 is ct                        # written in place


@pytest.mark.parametrize("backend", ["digital", "bpbs"])
def test_mla_padded_prefill_matches_reference(backend):
    """Row 0 left-padded by 4: pads hidden from attention, the latents and
    rope keys written left-aligned; then a decode step at each row's own
    length."""
    jc, tc, pj, pt, x = _setup(backend)
    mask = np.ones((2, 12), bool)
    mask[0, :4] = False
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0)
    cj, ct = _caches(jc, tc)
    cj, ct = _run(
        lambda: jattn.mla_attention(pj, jnp.asarray(x), jc, jnp.asarray(pos),
                                    cj, dtype=jnp.float32,
                                    pad_mask=jnp.asarray(mask)),
        lambda: tattn.mla_attention(pt, torch.from_numpy(x), tc,
                                    torch.from_numpy(pos), ct,
                                    dtype=torch.float32,
                                    pad_mask=torch.from_numpy(mask)))
    assert not ct.c_kv[0, 8:].any() and ct.c_kv[0, :8].abs().sum() > 0
    cp = mask.sum(1)
    _run(lambda: jattn.mla_attention(
            pj, jnp.asarray(x[:, :1]), jc, jnp.asarray(cp[:, None]), cj,
            jnp.asarray(cp), dtype=jnp.float32),
         lambda: tattn.mla_attention(
            pt, torch.from_numpy(x[:, :1]), tc,
            torch.from_numpy(cp[:, None]), ct, torch.from_numpy(cp),
            dtype=torch.float32))


@pytest.mark.parametrize("backend", ["digital", "bpbs"])
def test_mla_resumed_prefill_matches_reference(backend):
    """A head prefill of 5 tokens, then the next 4 written at rows'
    absolute positions (5 and 5) and attending causally over the cache:
    the reference's resume, and on ``digital`` the full prefill's last
    positions."""
    jc, tc, pj, pt, x = _setup(backend)
    cj, ct = _caches(jc, tc)
    head = np.arange(5)
    cj, ct = _run(
        lambda: jattn.mla_attention(pj, jnp.asarray(x[:, :5]), jc,
                                    jnp.asarray(head), cj, dtype=jnp.float32),
        lambda: tattn.mla_attention(pt, torch.from_numpy(x[:, :5]), tc,
                                    torch.from_numpy(head), ct,
                                    dtype=torch.float32))
    cp = np.full((2,), 5)
    pos = cp[:, None] + np.arange(4)[None]
    oj, _ = jattn.mla_attention(pj, jnp.asarray(x[:, 5:9]), jc,
                                jnp.asarray(pos), cj, jnp.asarray(cp),
                                dtype=jnp.float32)
    with torch.inference_mode():
        ot, _ = tattn.mla_attention(pt, torch.from_numpy(x[:, 5:9]), tc,
                                    torch.from_numpy(pos), ct,
                                    torch.from_numpy(cp),
                                    dtype=torch.float32)
        full, _ = tattn.mla_attention(pt, torch.from_numpy(x[:, :9]), tc,
                                      torch.arange(9), dtype=torch.float32)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
    if backend == "digital":
        torch.testing.assert_close(ot, full[:, 5:9], **TOL)


@pytest.mark.parametrize("backend", ["digital", "bpbs"])
def test_mla_writes_past_the_cache_are_dropped(backend):
    """Positions at or past the end of the latent cache are dropped, as the
    reference's ``.at[].set`` drops them: a decode step with one row past
    the end (a retired batcher slot's position runs on) and a resumed
    chunk straddling the end; outputs and caches equal the reference's."""
    jc, tc, pj, pt, x = _setup(backend)
    cj, ct = _caches(jc, tc)
    head = np.arange(8)
    cj, ct = _run(
        lambda: jattn.mla_attention(pj, jnp.asarray(x[:, :8]), jc,
                                    jnp.asarray(head), cj, dtype=jnp.float32),
        lambda: tattn.mla_attention(pt, torch.from_numpy(x[:, :8]), tc,
                                    torch.from_numpy(head), ct,
                                    dtype=torch.float32))
    for cp, s in ((np.array([15, 17]), 1), (np.array([14, 20]), 4)):
        pos = cp[:, None] + np.arange(s)[None]
        cj, _ = _run(
            lambda: jattn.mla_attention(
                pj, jnp.asarray(x[:, 8:8 + s]), jc, jnp.asarray(pos), cj,
                jnp.asarray(cp), dtype=jnp.float32),
            lambda: tattn.mla_attention(
                pt, torch.from_numpy(x[:, 8:8 + s]), tc,
                torch.from_numpy(pos), ct, torch.from_numpy(cp),
                dtype=torch.float32))
