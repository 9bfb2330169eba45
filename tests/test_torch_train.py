"""The port's training substrate against the JAX package: AdamW and its
schedule, gradient compression, the synthetic data and its prefetcher,
``loss_fn`` and its gradients, the train step, checkpoints and the
fault-tolerant trainer, on reduced olmo-1b (4 layers, d_model 128,
float32) with the reference's parameters converted key for key.

Tolerances:

* Data batches: bitwise (both draw numpy's ``SeedSequence([seed, step])``).
* AdamW, schedule, compression: rtol 1e-6 of each leaf's largest
  magnitude; the same float32 operations, with ``cos``, ``pow`` and the
  norm's sums possibly an ulp apart (XLA vs torch).
* ``loss_fn`` on the ``kernel`` backend (the port's plain version) against
  the Pallas kernel in interpret mode: loss rtol 1e-5, gradients rtol 1e-4
  of each leaf's largest magnitude (float32 GEMMs and reductions summed
  in another order through four layers).  Remat on and off (and the
  attention chunk checkpoint) change no bit of the port's loss or
  gradients.
* Three train steps (``digital`` backend, the reduced config's policy):
  losses and gradient norms rtol 1e-5; parameters as
  :func:`_params_close` states (AdamW's normalized update of a gradient
  element that cancels to near zero takes its sign from the summation
  order); the compression error feedback within one quantization step
  (twice the leaf's largest residual): an element on a rounding boundary
  may round one step apart.
* Checkpoints: bitwise, in both directions between the packages.
* The trainer: a crashed-and-resumed run lands on the uninterrupted run's
  final loss bitwise (same data, same arithmetic on the CPU).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import accel as jaccel
from repro.configs import get_config as jget
from repro.data import pipeline as jdata
from repro.models import init_params as jinit
from repro.models import loss_fn as jloss
from repro.models.attention import _chunked_attention as jchunked
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.train import checkpoint as jckpt
from repro.train.state import init_train_state as jinit_state
from repro.train.step import build_train_step as jbuild_step
from repro_torch.accel import ProgramManager
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.data import pipeline as tdata
from repro_torch.models import loss_fn as tloss
from repro_torch.models.attention import _chunked_attention as tchunked
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tcomp
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.state import TrainState
from repro_torch.train.state import init_train_state as tinit_state
from repro_torch.train.step import build_train_step as tbuild_step
from repro_torch.train.step import value_and_grad
from repro_torch.train.trainer import CrashInjected, TrainerConfig, train
from repro_torch.tree import leaves, leaves_with_path


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _close(got, want, rtol, atol=0.0):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * np.abs(want).max() + atol)


def _to_port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _tree_close(got, want, rtol, atol=0.0):
    """Every leaf of the port's tree against the reference's, matched by
    name (``keystr``)."""
    want = dict(zip((jax.tree_util.keystr(p) for p, _ in
                     jax.tree_util.tree_flatten_with_path(want)[0]),
                    jax.tree_util.tree_leaves(want)))
    got = dict(leaves_with_path(got))
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k].numpy(), want[k], rtol, atol)


@pytest.fixture(scope="module")
def olmo():
    """(reference config, port config, reference params)."""
    jc = jget("olmo-1b").reduced()
    return jc, tget("olmo-1b").reduced(), jinit(jc, jax.random.PRNGKey(0))


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("step", [0, 5, 123])
def test_batches_bitwise_equal_to_reference(step):
    lm = dict(seq_len=32, global_batch=4, vocab=101, seed=7)
    cf = dict(kind="cifar_synthetic", global_batch=6, seed=1)
    for kw in (lm, cf):
        want = jdata.make_batch(jdata.DataConfig(**kw), step)
        got = tdata.make_batch(tdata.DataConfig(**kw), step, "cpu")
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == torch.int32 or got[k].dtype == \
                torch.float32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    cfg = tdata.DataConfig(**lm)
    assert not torch.equal(tdata.make_batch(cfg, step, "cpu")["tokens"],
                           tdata.make_batch(cfg, step + 1, "cpu")["tokens"])


def test_prefetcher_matches_direct_batches():
    cfg = tdata.DataConfig(seq_len=16, global_batch=2, vocab=50, seed=3)
    pf = tdata.Prefetcher(cfg, start_step=4, device="cpu")
    try:
        for expect in range(4, 8):
            step, batch = next(pf)
            assert step == expect
            assert torch.equal(batch["tokens"],
                               tdata.make_batch(cfg, step, "cpu")["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_raises_what_its_worker_raised():
    pf = tdata.Prefetcher(tdata.DataConfig(kind="nope"), device="cpu")
    try:
        with pytest.raises(ValueError, match="nope"):
            next(pf)
    finally:
        pf.close()


# ----------------------------------------------------------------- AdamW

def _tree(seed):
    r = np.random.default_rng(seed)
    return {"w": r.normal(size=(5, 3)).astype(np.float32),
            "b": {"z": r.normal(size=(3,)).astype(np.float32),
                  "a": [r.normal(size=(2, 2)).astype(np.float32)]}}


@pytest.mark.parametrize("count", [0, 3, 150])
def test_adamw_step_and_schedule_match_reference(count):
    cfg = dict(lr=1e-2, warmup_steps=10, total_steps=200, clip_norm=0.5)
    p, g, m, v = (_tree(s) for s in range(4))
    v = jax.tree.map(np.abs, v)
    js = jadamw.OptState(m, v, jnp.asarray(count, jnp.int32))
    jp, jst, jm = jadamw.apply_updates(p, g, js, jadamw.AdamWConfig(**cfg))
    tt = lambda t: params_from_jax(t, "cpu")            # noqa: E731
    ts = tadamw.OptState(tt(m), tt(v), torch.tensor(count,
                                                    dtype=torch.int32))
    tp, tst, tm = tadamw.apply_updates(tt(p), tt(g), ts,
                                       tadamw.AdamWConfig(**cfg))
    _tree_close(tp, jp, 1e-6)
    _tree_close(tst.mu, jst.mu, 1e-6)
    _tree_close(tst.nu, jst.nu, 1e-6)
    assert int(tst.count) == int(jst.count) == count + 1
    for k in ("grad_norm", "lr"):
        _close(float(tm[k]), float(jm[k]), 1e-6)
    for step in (0, 5, 9, 10, 11, 100, 199, 250):
        want = float(jadamw.schedule(jadamw.AdamWConfig(**cfg),
                                     jnp.asarray(step)))
        got = float(tadamw.schedule(tadamw.AdamWConfig(**cfg),
                                    torch.tensor(step)))
        _close(got, want, 1e-6)


def test_adamw_converges_on_a_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    cfg = tadamw.AdamWConfig(lr=0.2, weight_decay=0.0, warmup_steps=0,
                             total_steps=200)
    state = tadamw.init_opt_state(params)
    for _ in range(200):
        params, state, _ = tadamw.apply_updates(params, {"w": 2 * params["w"]},
                                                state, cfg)
    assert float(params["w"].abs().max()) < 1e-2


# ----------------------------------------------------------- compression

@pytest.mark.parametrize("bits", [8, 4])
def test_compress_decompress_matches_reference(bits):
    g, e = _tree(7), jax.tree.map(lambda a: 0.01 * a, _tree(8))
    jr, je = jcomp.compress_decompress(g, e, bits)
    tr, te = tcomp.compress_decompress(params_from_jax(g, "cpu"),
                                       params_from_jax(e, "cpu"), bits)
    _tree_close(tr, jr, 1e-6)
    _tree_close(te, je, 1e-6)


def test_compression_error_feedback_preserves_signal():
    """The mean compressed gradient tracks the true one at 4 bits."""
    g = {"g": torch.from_numpy(np.random.default_rng(0).normal(
        size=64).astype(np.float32))}
    err, total = tcomp.init_error_state(g), torch.zeros(64)
    for _ in range(50):
        red, err = tcomp.compress_decompress(g, err, bits=4)
        total = total + red["g"]
    torch.testing.assert_close(total / 50, g["g"], rtol=0, atol=0.05)


# ------------------------------------------------------- loss and grads

def _lm_batch(cfg, step=0, seq=16, batch=4):
    kw = dict(seq_len=seq, global_batch=batch, vocab=cfg.vocab, seed=11)
    return jdata.make_batch(jdata.DataConfig(**kw), step), \
        tdata.make_batch(tdata.DataConfig(**kw), step, "cpu")


def test_loss_fn_and_gradients_match_reference_remat_on_and_off(olmo):
    """``kernel`` (its plain version) against the Pallas kernel in
    interpret mode; the port's remat changes no bit."""
    jc, tc, pj = olmo
    jc = jc.with_accel("pallas", ba=4, bx=4)
    tc = tc.with_accel("kernel", ba=4, bx=4)
    bj, bt = _lm_batch(jc, seq=8, batch=2)
    (lj, mj), gj = jax.value_and_grad(
        lambda p: jloss(p, bj, jc), has_aux=True)(pj)
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tc, remat=remat)
        out[remat] = value_and_grad(lambda p: tloss(p, bt, cfg),
                                    _to_port(pj))
    (lt, mt), gt = out[True]
    assert float(lt) == float(out[False][0][0])
    for a, b in zip(leaves(gt), leaves(out[False][1])):
        assert torch.equal(a, b)
    _close(float(lt), float(lj), 1e-5)
    for k in ("ce", "aux", "tokens"):
        _close(float(mt[k]), float(mj[k]), 1e-5)
    _tree_close(gt, gj, 1e-4)


@pytest.mark.parametrize("window", [None, 24])
def test_attention_chunk_checkpoint_keeps_values_and_gradients(window):
    """``scan_remat`` recomputes each chunk step in the backward pass: the
    same output and gradients as without it (bitwise) and as the
    reference's ``jax.checkpoint``-ed scan (rtol 1e-5)."""
    r = np.random.default_rng(4)
    q, k, v = (r.normal(size=(2, 40, 4, 16)).astype(np.float32)
               for _ in range(3))
    kw = dict(causal=True, window=window, q_offset=0, scale=0.25,
              dtype=jnp.float32, chunk=16)

    def jf(q, k, v):
        return jnp.sum(jchunked(q, k, v, scan_remat=True, **kw) ** 2)

    jg = jax.grad(jf, argnums=(0, 1, 2))(q, k, v)
    got = {}
    for remat in (False, True):
        ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        o = tchunked(*ts, scan_remat=remat, **dict(kw, dtype=torch.float32))
        (o ** 2).sum().backward()
        got[remat] = (o.detach(), [t.grad for t in ts])
    assert torch.equal(got[True][0], got[False][0])
    for a, b, c in zip(got[True][1], got[False][1], jg):
        assert torch.equal(a, b)
        _close(a.numpy(), c, 1e-5)


# ------------------------------------------------------------ train step

def _params_close(got, want, lr_sum: float, rtol=1e-5):
    """Parameters after AdamW steps: every element within ``rtol`` of its
    leaf's largest magnitude plus twice the summed learning rates (the
    most a normalized update can move an element per step, reached when a
    gradient element cancels to near zero and its sign comes from the
    summation order), and at most one element in a thousand of each leaf
    beyond ``rtol`` plus a hundredth of that sum."""
    want = dict(zip((jax.tree_util.keystr(p) for p, _ in
                     jax.tree_util.tree_flatten_with_path(want)[0]),
                    jax.tree_util.tree_leaves(want)))
    got = dict(leaves_with_path(got))
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = np.asarray(w)
        d = np.abs(got[k].numpy() - w)
        tol = rtol * np.abs(w).max()
        assert d.max() <= tol + 2 * lr_sum, (k, d.max())
        assert (d > tol + 0.01 * lr_sum).sum() <= max(1, d.size // 1000), k


@pytest.mark.parametrize("variant", ["plain", "microbatches", "compression"])
def test_three_train_steps_match_reference(olmo, variant):
    jc, tc, pj = olmo
    opt = dict(lr=3e-3, warmup_steps=2, total_steps=6)
    comp = variant == "compression"
    mb = 2 if variant == "microbatches" else 1
    jstep = jax.jit(jbuild_step(jc, jadamw.AdamWConfig(**opt),
                                jcomp.CompressionConfig() if comp else None,
                                microbatches=mb))
    tstep = tbuild_step(tc, tadamw.AdamWConfig(**opt),
                        tcomp.CompressionConfig() if comp else None,
                        microbatches=mb)
    js = jinit_state(pj, use_compression=comp)
    ts = tinit_state(_to_port(pj), use_compression=comp)
    lr_sum = 0.0
    for step in range(3):
        bj, bt = _lm_batch(jc, step)
        js, mj = jstep(js, bj)
        ts, mt = tstep(ts, bt)
        assert set(mt) == set(mj)
        for k in ("loss", "ce", "tokens", "grad_norm", "lr"):
            _close(float(mt[k]), float(mj[k]), 1e-5)
        lr_sum += float(mj["lr"])
        _params_close(ts.params, js.params, lr_sum)
    assert int(ts.step) == int(js.step) == 3
    if comp:    # a residual is at most half a quantization step
        _tree_close(ts.error, js.error, 2.0)


def test_eval_step_reports_the_loss(olmo):
    from repro_torch.train.step import build_eval_step

    jc, tc, pj = olmo
    bj, bt = _lm_batch(jc)
    m = build_eval_step(tc)(_to_port(pj), bt)
    _, mj = jloss(pj, bj, jc)
    _close(float(m["loss"]), float(mj["loss"]), 1e-5)
    assert not m["loss"].requires_grad


# ----------------------------------------------------------- checkpoints

def test_checkpoint_roundtrip_and_jax_interchange(tmp_path, olmo):
    jc, _, pj = olmo
    js = jinit_state(pj)
    ts = tinit_state(_to_port(pj))
    # a JAX-written checkpoint restores into the port, bit for bit
    path = jckpt.save(str(tmp_path / "jax"), 7, js)
    got, step = tckpt.restore(path, ts)
    assert step == 7 and isinstance(got, TrainState)
    _tree_close(got, js, 0.0)
    assert got.step.dtype == torch.int32 and got.opt.count.dtype == \
        torch.int32
    # and a port-written one into the JAX package
    path = tckpt.save(str(tmp_path / "port"), 9, got)
    back, step = jckpt.restore(path, js)
    assert step == 9
    _tree_close(got, back, 0.0)
    # bf16 leaves are stored wide and come back bf16
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    path = tckpt.save(str(tmp_path / "bf16"), 12, tree)
    restored, step = tckpt.restore(path, tree)
    assert step == 12 and restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["a"], tree["a"])
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore(path, {"a": torch.zeros(3), "b": tree["b"]})


def test_checkpoint_gc_latest_and_async(tmp_path):
    tree = {"x": torch.zeros(2)}
    for s in (10, 20, 30, 40):
        tckpt.save(str(tmp_path), s, tree)
    tckpt.gc_old(str(tmp_path), keep=2)
    assert [s for s, _ in tckpt.list_checkpoints(str(tmp_path))] == [30, 40]
    assert tckpt.latest_checkpoint(str(tmp_path)).endswith("step_00000040")
    saver = tckpt.AsyncCheckpointer(str(tmp_path / "async"), keep=1)
    x = torch.ones(3)
    saver.save(5, {"x": x})
    x.add_(1)                                  # the snapshot was taken
    saver.wait()
    got, step = tckpt.restore(tckpt.latest_checkpoint(
        str(tmp_path / "async")), {"x": torch.zeros(3)})
    assert step == 5 and torch.equal(got["x"], torch.ones(3))


# --------------------------------------------------------------- trainer

def _tiny(tmp_path, total_steps, crash_at=None):
    cfg = tget("olmo-1b").reduced()
    data_cfg = tdata.DataConfig(seq_len=16, global_batch=4, vocab=cfg.vocab,
                                seed=11)
    opt_cfg = tadamw.AdamWConfig(lr=1e-3, warmup_steps=2,
                                 total_steps=total_steps)
    tcfg = TrainerConfig(total_steps=total_steps, ckpt_dir=str(tmp_path),
                         ckpt_every=2, log_every=100, crash_at_step=crash_at)
    return cfg, data_cfg, opt_cfg, tcfg


def test_trainer_crash_and_resume_is_bitwise(tmp_path):
    quiet = lambda s: None                                # noqa: E731
    cfg, d, o, t = _tiny(tmp_path / "ref", 6)
    _, hist_ref = train(cfg, d, o, t, log_fn=quiet, device="cpu")
    cfg, d, o, t = _tiny(tmp_path / "crash", 6, crash_at=4)
    pm = ProgramManager(cfg)
    with pytest.raises(CrashInjected):
        train(cfg, d, o, t, log_fn=quiet, device="cpu", program_manager=pm)
    assert pm.invalidations == 4
    t2 = TrainerConfig(total_steps=6, ckpt_dir=t.ckpt_dir, ckpt_every=2,
                       log_every=100)
    _, hist_res = train(cfg, d, o, t2, log_fn=quiet, device="cpu")
    assert hist_res[0]["step"] == 4
    assert hist_ref[-1]["step"] == hist_res[-1]["step"] == 5
    assert hist_ref[-1]["loss"] == hist_res[-1]["loss"]


def test_trainer_loss_decreases(tmp_path):
    cfg, d, o, t = _tiny(tmp_path, 12)
    o = tadamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=12)
    _, hist = train(cfg, d, o, t, log_fn=lambda s: None, device="cpu")
    first = np.mean([h["loss"] for h in hist[:3]])
    last = np.mean([h["loss"] for h in hist[-3:]])
    assert last < first, (first, last)
