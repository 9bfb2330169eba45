"""The port's paged serving (``repro_torch.serve.kv``, ``PagedScheduler``)
against its own slot batcher and against the JAX package.

Ports ``tests/test_paged.py`` case by case, without its mesh test:
allocator units, config validation, the layout probe, paged streams
equal to the port's ``ContinuousBatcher`` token for token (ragged
lengths, budgets, EOS, sampling, deferred admission, preemption,
chunked prefill, a property over random traffic) on ``digital``,
``bpbs`` and ``kernel`` (the CUDA kernel's plain version on these CPU
tensors).  Beside them: ``gather_cache``, ``scatter_decode`` and
``splice_request`` bitwise against ``repro.serve.kv`` on random pools,
and the port's greedy streams and stats equal to the JAX
``PagedScheduler``'s (``kernel`` against ``pallas`` in interpret mode).
Sampled streams are held within the port only: torch cannot reproduce
JAX's PRNG.

Reduced configs, float32, parameters from the reference's
``init_params`` converted key for key.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyp_compat import given, settings, st
from repro.configs import get_config as jget
from repro.models import init_params as jinit
from repro.serve import PagedScheduler as JPaged
from repro.serve import ServeConfig as JServe
from repro.serve import kv as jkv
from repro_torch import tree
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.models import DecodeCache
from repro_torch.serve import (BlockAllocator, ContinuousBatcher,
                               PagedScheduler, ServeConfig, build_layout)
from repro_torch.serve import kv
from repro_torch.serve import scheduler as sched_mod
from repro_torch.serve.kv import required_blocks

KEY = jax.random.PRNGKey(0)
JAX_NAME = {"digital": "digital", "bpbs": "bpbs", "kernel": "pallas"}
_CACHE: dict = {}


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _params(name):
    """(JAX config, port config, JAX params, port params) of a reduced
    config, parameters drawn once by the reference."""
    if name not in _CACHE:
        jc = jget(name).reduced()
        pj = jinit(jc, KEY, max_seq=64)
        pt = params_from_jax(jax.tree.map(np.asarray, pj), "cpu")
        _CACHE[name] = (jc, tget(name).reduced(), pj, pt)
    return _CACHE[name]


def _setup(name="olmo-1b", max_seq=48, backend="digital", **scfg_kw):
    _, cfg, _, params = _params(name)
    if backend != "digital":
        cfg = cfg.with_accel(backend, ba=4, bx=4, bank_n=16)
    scfg_kw.setdefault("kv_block_size", 8)
    return cfg, params, ServeConfig(max_seq=max_seq, **scfg_kw)


def _ragged_prompts(n, vocab, seed=1, lengths=(3, 9, 5, 13, 7, 4, 11, 6)):
    """tests/test_paged.py's ragged prompts."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (lengths[i % len(lengths)],)
                         ).astype(np.int32) for i in range(n)]


def _run_pair(cfg, params, scfg, prompts, budgets=None, n_slots=3,
              num_blocks=None, priorities=None):
    """Same trace through the port's slot batcher and paged scheduler;
    returns (slot results, paged results, paged scheduler)."""
    budgets = budgets or [None] * len(prompts)
    cb = ContinuousBatcher(params, cfg, scfg, n_slots=n_slots, device="cpu")
    for p, m in zip(prompts, budgets):
        cb.submit(p, max_new_tokens=m)
    ref = cb.run()
    ps = PagedScheduler(params, cfg, scfg, n_slots=n_slots,
                        num_blocks=num_blocks, device="cpu")
    for k, (p, m) in enumerate(zip(prompts, budgets)):
        ps.submit(p, max_new_tokens=m,
                  priority=priorities[k] if priorities else 0)
    got = ps.run()
    assert set(ref) == set(got)
    for rid in ref:
        assert ref[rid] == got[rid], (rid, ref[rid], got[rid])
    return ref, got, ps


# ----------------------------------------------------------- allocator

def test_allocator_alloc_free_cycle():
    a = BlockAllocator(6)
    x = a.alloc(4)
    assert sorted(x) == [0, 1, 2, 3] and a.available == 2
    a.free(x[:2])
    y = a.alloc(3)
    assert y is not None and a.available == 1
    assert len(set(x[2:]) | set(y)) == 5          # no id handed out twice


def test_allocator_oom_returns_none_not_partial():
    a = BlockAllocator(4)
    assert a.alloc(3) is not None
    assert a.alloc(2) is None                     # would need 5 total
    assert a.available == 1                       # nothing leaked
    assert a.alloc(1) is not None


def test_allocator_fragmentation_free():
    """Block ids are interchangeable: freeing ANY n blocks makes any
    n-block request satisfiable."""
    a = BlockAllocator(8)
    held = a.alloc(8)
    a.free(held[1::2])
    assert a.alloc(4) is not None


def test_allocator_double_free_raises():
    a = BlockAllocator(4)
    ids = a.alloc(2)
    a.free(ids)
    with pytest.raises(ValueError):
        a.free(ids[:1])
    with pytest.raises(ValueError):
        BlockAllocator(0)


# ------------------------------------------------------ config validation

@pytest.mark.parametrize("kw", [
    dict(max_seq=0), dict(max_new_tokens=0), dict(eos_check_every=0),
    dict(eos_check_every=-2), dict(kv_block_size=0),
    dict(max_seq=48, kv_block_size=7),            # does not divide
    dict(decode_block=0), dict(prefill_chunk=0), dict(prefill_chunk=-4),
    dict(max_admit_per_step=0), dict(temperature=-0.1),
])
def test_serve_config_rejects(kw):
    base = dict(max_seq=64, max_new_tokens=8)
    base.update(kw)
    with pytest.raises(ValueError):
        ServeConfig(**base)


def test_serve_config_paged_defaults_match_the_reference():
    got, want = ServeConfig(), JServe()
    for name in ("kv_block_size", "decode_block", "prefill_chunk"):
        assert getattr(got, name) == getattr(want, name)


def test_n_slots_validated():
    cfg, params, scfg = _setup()
    with pytest.raises(ValueError):
        ContinuousBatcher(params, cfg, scfg, n_slots=0, device="cpu")
    with pytest.raises(ValueError):
        PagedScheduler(params, cfg, scfg, n_slots=-1, device="cpu")


def test_submit_rejects_impossible_request():
    cfg, params, scfg = _setup(max_new_tokens=16)
    ps = PagedScheduler(params, cfg, scfg, n_slots=2, num_blocks=2,
                        device="cpu")
    with pytest.raises(ValueError):               # needs 4 blocks of 8
        ps.submit(np.arange(1, 30, dtype=np.int32))
    ps.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=8)


def test_paged_scheduler_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg, params, scfg = _setup()
    with pytest.raises((RuntimeError, AssertionError)):
        PagedScheduler(params, cfg, scfg, n_slots=2)


# ------------------------------------------------------------- layout

def _same_layout(name, n_slots, s_max, bs):
    """The port's layout equals the reference's, leaf for leaf."""
    got = build_layout(tget(name).reduced(), n_slots, s_max, bs)
    want = jkv.build_layout(jget(name).reduced(), n_slots, s_max, bs)
    for f in ("batch_axes", "seq_axes", "lengths", "leaf_shapes",
              "block_size", "num_blocks", "table_width", "n_slots", "s_max"):
        assert getattr(got, f) == getattr(want, f), f
    assert [str(d).split(".")[-1] for d in got.leaf_dtypes] == \
        [str(d) for d in want.leaf_dtypes]
    return got


def test_layout_classifies_attention_and_state_leaves():
    lay = _same_layout("olmo-1b", 3, 48, 8)
    assert lay.table_width == 48 // 8
    assert any(q is not None for q in lay.seq_axes)      # KV leaves page
    assert lay.num_blocks == 3 * lay.table_width         # full residency
    # no memory behind the probe's template
    assert all(t.is_meta for t in tree.leaves(lay.treedef))

    # pure-SSM cache has no sequence-indexed leaves: paging degenerates to
    # per-slot state copies
    lay2 = _same_layout("mamba2-130m", 3, 48, 8)
    assert all(q is None for q in lay2.seq_axes)
    assert lay2.table_width == 1

    with pytest.raises(ValueError):                      # 48 % 7 != 0
        build_layout(tget("olmo-1b").reduced(), n_slots=3, s_max=48,
                     block_size=7)


@pytest.mark.parametrize("s_max", [48, 128])
def test_layout_recurrentgemma_pages_kv_beside_lru_states(s_max):
    """The attention leaf tracks ``s_max`` while the window (64 reduced)
    covers it and pages beside the LRU states; past the window it is a
    ring cache of the window's length and stays per-slot state."""
    lay = _same_layout("recurrentgemma-9b", 3, s_max, 8)
    paged = [L for L in lay.lengths if L is not None]
    assert paged == ([s_max, s_max] if s_max <= 64 else [])
    assert sum(q is None for q in lay.seq_axes) >= 4     # LRU conv, h


def test_layout_deepseek_pages_mla_latents():
    """MLA's latent and rope-key caches page in the dense first layer
    (batch axis 0) and the stacked MoE layers (batch axis 1)."""
    lay = _same_layout("deepseek-v2-lite-16b", 2, 48, 8)
    assert lay.seq_axes == (1, 1, 2, 2)
    assert lay.batch_axes == (0, 0, 1, 1)


def test_whisper_refused():
    cfg = tget("whisper-tiny").reduced()
    assert cfg.is_encdec
    with pytest.raises(NotImplementedError):
        build_layout(cfg, 1, 32, 8)
    with pytest.raises(NotImplementedError):
        PagedScheduler(None, cfg, ServeConfig(max_seq=32, max_new_tokens=4,
                                              kv_block_size=8), n_slots=1,
                       device="cpu")


def test_required_blocks():
    lay = build_layout(tget("olmo-1b").reduced(), 2, 48, 8)
    assert required_blocks(1, lay) == 1
    assert required_blocks(8, lay) == 1
    assert required_blocks(9, lay) == 2
    assert required_blocks(480, lay) == lay.table_width  # ring-capped
    row = kv.host_table_row(lay, [4, 1])
    assert row.tolist() == [4, 1] + [lay.sentinel] * (lay.table_width - 2)


# ---------------------------------------- gather / scatter vs the reference

NB, BS, B = 7, 8, 3
# (name, shape at batch B, batch axis, sequence axis or None, dtype): an
# olmo-like stacked KV leaf, a leaf shorter than the table (wraps modulo
# its own 2 blocks), a bf16 one and a per-slot state leaf
LEAVES = [("a", (2, B, 32, 2, 3), 1, 2, "float32"),
          ("b", (B, 16, 5), 0, 1, "float32"),
          ("c", (B, 32, 4), 0, 1, "bfloat16"),
          ("s", (2, B, 6), 1, None, "float32")]


def _layouts():
    """The same hand-made layout in both packages."""
    shapes = {n: s for n, s, *_ in LEAVES}
    _, treedef = jax.tree_util.tree_flatten(
        {n: np.zeros(s, np.float32) for n, s in shapes.items()})
    common = dict(
        batch_axes=tuple(b for *_, b, _, _ in LEAVES),
        seq_axes=tuple(q for *_, q, _ in LEAVES),
        lengths=tuple(s[q] if q is not None else None
                      for _, s, _, q, _ in LEAVES),
        leaf_shapes=tuple(s for _, s, *_ in LEAVES),
        block_size=BS, num_blocks=NB, table_width=4, n_slots=B, s_max=32)
    want = jkv.PagedLayout(
        treedef=treedef, leaf_dtypes=tuple(jnp.dtype(d) for *_, d in LEAVES),
        **common)
    got = kv.PagedLayout(
        treedef={n: torch.empty(s, device="meta") for n, s in shapes.items()},
        leaf_dtypes=tuple(getattr(torch, d) for *_, d in LEAVES), **common)
    return got, want


def _pair(a: np.ndarray, dtype: str):
    """The same values in both packages (bf16 rounds alike in both)."""
    return (torch.from_numpy(a).to(getattr(torch, dtype)),
            jnp.asarray(a).astype(jnp.dtype(dtype)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x.astype(jnp.float32))


def _random_pools(rng, got, want):
    """Random pools: the reference's over NB blocks, the port's with the
    zero-read and discard blocks after them."""
    t_leaves, j_leaves = [], []
    for (b_ax, q_ax, _L, shape, _), (_, _, _, _, d) in zip(
            kv._iter_meta(got), LEAVES):
        if q_ax is not None:
            shape = shape[:b_ax] + (NB, BS) + shape[q_ax + 1:]
        t, j = _pair(rng.standard_normal(shape).astype(np.float32), d)
        if q_ax is not None:
            extra = list(t.shape)
            extra[b_ax] = 2
            t = torch.cat([t, torch.zeros(extra, dtype=t.dtype)], dim=b_ax)
        t_leaves.append(t)
        j_leaves.append(j)
    tp = kv.PagedCache(tree.unflatten(got.treedef, t_leaves),
                       torch.from_numpy(rng.integers(0, 40, B)))
    jp = jkv.PagedCache(jax.tree_util.tree_unflatten(want.treedef, j_leaves),
                        jnp.asarray(tp.pos.numpy(), jnp.int32))
    return tp, jp


def _random_tables(rng):
    """Distinct physical blocks per entry, some entries the sentinel, one
    row (a retired one) all sentinel."""
    ids = rng.permutation(NB)
    tables = np.full((B, 4), NB, np.int64)
    tables[0, :3] = ids[:3]
    tables[1, [0, 2, 3]] = ids[3:6]
    return tables


def _assert_pools_equal(tp, jp, got):
    for t, j, (b_ax, q_ax, *_rest) in zip(
            tree.leaves(tp.pools), jax.tree_util.tree_leaves(jp.pools),
            kv._iter_meta(got)):
        if q_ax is None:
            np.testing.assert_array_equal(_np(t), _np(j))
            continue
        np.testing.assert_array_equal(_np(t.narrow(b_ax, 0, NB)), _np(j))
        assert not t.narrow(b_ax, NB, 1).any(), "the zero block was written"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_cache_bitwise_to_the_reference(seed):
    rng = np.random.default_rng(seed)
    got, want = _layouts()
    tp, jp = _random_pools(rng, got, want)
    tables = _random_tables(rng)
    dt = kv.gather_cache(tp, torch.from_numpy(tables), got)
    dj = jkv.gather_cache(jp, jnp.asarray(tables, jnp.int32), want)
    for t, j, pool in zip(tree.leaves(dt.layers),
                          jax.tree_util.tree_leaves(dj.layers),
                          tree.leaves(tp.pools)):
        np.testing.assert_array_equal(_np(t), _np(j))
        assert t.shape == tuple(j.shape)
    # paged leaves are fresh tensors, state leaves the pool's own
    fresh = [t is not p for t, p in zip(tree.leaves(dt.layers),
                                        tree.leaves(tp.pools))]
    assert fresh == [q is not None for q in got.seq_axes]
    assert dt.pos is tp.pos


@pytest.mark.parametrize("seed,k", [(0, 8), (1, 11), (2, 1), (3, 20)])
def test_scatter_decode_bitwise_to_the_reference(seed, k):
    """Random dense views written back at wrapped start positions (up to
    twice the leaves' lengths), sentinel entries and a retired row: the
    first NB blocks equal the reference's, bit for bit, and the zero
    block is still zero; the pool is written in place."""
    rng = np.random.default_rng(seed)
    got, want = _layouts()
    tp, jp = _random_pools(rng, got, want)
    tables = _random_tables(rng)
    dense_t, dense_j = [], []
    for shape, (*_, d) in zip(got.leaf_shapes, LEAVES):
        t, j = _pair(rng.standard_normal(shape).astype(np.float32), d)
        dense_t.append(t)
        dense_j.append(j)
    start = rng.integers(0, 64, B)
    new_pos = torch.from_numpy(start + k)
    before = [t.data_ptr() for t in tree.leaves(tp.pools)]
    out_t = kv.scatter_decode(
        tp, DecodeCache(tree.unflatten(got.treedef, dense_t), new_pos),
        torch.from_numpy(tables), got, torch.from_numpy(start), k)
    out_j = jkv.scatter_decode(
        jp, jkv.DecodeCache(jax.tree_util.tree_unflatten(want.treedef,
                                                         dense_j),
                            jnp.asarray(start + k, jnp.int32), None),
        jnp.asarray(tables, jnp.int32), want, jnp.asarray(start, jnp.int32),
        k)
    _assert_pools_equal(out_t, out_j, got)
    assert [t.data_ptr() for t in tree.leaves(out_t.pools)] == before
    assert out_t.pos is new_pos


@pytest.mark.parametrize("seed,i", [(0, 0), (1, 2)])
def test_splice_request_bitwise_to_the_reference(seed, i):
    rng = np.random.default_rng(seed)
    got, want = _layouts()
    tp, jp = _random_pools(rng, got, want)
    slot_t, slot_j = [], []
    for (b_ax, *_rest), shape, (*_, d) in zip(
            kv._iter_meta(got), got.leaf_shapes, LEAVES):
        shape = shape[:b_ax] + (1,) + shape[b_ax + 1:]
        t, j = _pair(rng.standard_normal(shape).astype(np.float32), d)
        slot_t.append(t)
        slot_j.append(j)
    row = np.full(4, NB, np.int64)
    row[:2] = rng.permutation(NB)[:2]
    pos = int(rng.integers(1, 32))
    out_t = kv.splice_request(
        tp, DecodeCache(tree.unflatten(got.treedef, slot_t),
                        torch.tensor([pos])), i, torch.from_numpy(row), got)
    out_j = jkv.splice_request(
        jp, jkv.DecodeCache(jax.tree_util.tree_unflatten(want.treedef,
                                                         slot_j),
                            jnp.asarray([pos], jnp.int32), None),
        i, jnp.asarray(row, jnp.int32), want)
    _assert_pools_equal(out_t, out_j, got)
    assert out_t.pos.tolist() == np.asarray(out_j.pos).tolist()


# ----------------------------------------------------------- parity

@pytest.mark.parametrize("name", ["olmo-1b", "mamba2-130m",
                                  "recurrentgemma-9b",
                                  "deepseek-v2-lite-16b"])
def test_paged_parity_greedy(name):
    """Paged == slot batcher token for token on ragged greedy traffic
    (attention pages, pure SSM degenerates to state copies, recurrentgemma
    mixes a paged KV leaf with LRU states, deepseek pages MLA latents)."""
    cfg, params, scfg = _setup(name, max_new_tokens=8)
    if cfg.moe:      # dropless: expert capacity is shared by a step's rows
        cfg = dataclasses.replace(cfg, moe_capacity_factor=64.0)
    _run_pair(cfg, params, scfg, _ragged_prompts(7, cfg.vocab))


@pytest.mark.parametrize("backend", ["bpbs", "kernel", "digital_int"])
def test_paged_parity_quantized_backends(backend):
    """Per-row input quantization (the serving default) makes each
    request's logits independent of its batch neighbours, so the two
    schedulers' different admission timing still gives equal streams."""
    cfg, params, scfg = _setup(backend=backend, max_new_tokens=6)
    _run_pair(cfg, params, scfg, _ragged_prompts(5, cfg.vocab))


def test_paged_parity_eos_truncation():
    """EOS mid-stream: retired rows' in-flight block writes must not
    corrupt survivors."""
    cfg, params, scfg = _setup(max_new_tokens=10)
    prompts = _ragged_prompts(6, cfg.vocab, seed=3)
    cb = ContinuousBatcher(params, cfg, scfg, n_slots=3, device="cpu")
    for p in prompts:
        cb.submit(p)
    probe = cb.run()
    eos = probe[0][len(probe[0]) // 2]            # an emitted token
    scfg2 = _setup(max_new_tokens=10, eos_id=int(eos))[2]
    ref, _, _ = _run_pair(cfg, params, scfg2, prompts)
    assert any(len(v) < 10 for v in ref.values()), "EOS never fired"


def test_paged_parity_ragged_budgets():
    cfg, params, scfg = _setup(max_new_tokens=12)
    prompts = _ragged_prompts(8, cfg.vocab, seed=5)
    budgets = [1, 12, 3, 7, 2, 12, 5, 4]
    ref, _, _ = _run_pair(cfg, params, scfg, prompts, budgets, n_slots=2)
    assert [len(ref[r]) for r in sorted(ref)] == budgets


def test_paged_parity_sampled_temperature():
    """Sampling is a function of (seed, request id, step): the K-step
    block reproduces the slot batcher's sampled streams exactly."""
    cfg, params, scfg = _setup(max_new_tokens=6, temperature=0.8, seed=11)
    _run_pair(cfg, params, scfg, _ragged_prompts(5, cfg.vocab, seed=7))


def test_paged_oom_defers_admission():
    """A pool far smaller than n_slots x table width: admissions are
    deferred (never dropped) and every stream still matches."""
    cfg, params, scfg = _setup(max_new_tokens=10)
    prompts = _ragged_prompts(6, cfg.vocab, seed=9)
    _, _, ps = _run_pair(cfg, params, scfg, prompts, n_slots=3,
                         num_blocks=3)
    assert ps.stats["deferred_admissions"] > 0
    assert ps.alloc.available == 3                # every block came back


def test_paged_preemption_by_recompute():
    """Decode-time block exhaustion preempts the least urgent row; its
    recomputed stream still matches the slot batcher's."""
    cfg, params, scfg = _setup(max_new_tokens=24)
    prompts = _ragged_prompts(4, cfg.vocab, seed=13)
    _, _, ps = _run_pair(cfg, params, scfg, prompts, n_slots=3,
                         num_blocks=5, priorities=[0, 1, 2, 3])
    assert ps.stats["preemptions"] > 0


def test_paged_chunked_prefill_parity():
    """Chunked admission prefill (prefill_chunk=4, dense attention, float):
    streams equal the slot batcher's whole-prompt prefills."""
    cfg, params, scfg = _setup(max_new_tokens=8, prefill_chunk=4)
    _, _, ps = _run_pair(cfg, params, scfg,
                         _ragged_prompts(6, cfg.vocab, seed=2))
    assert ps.stats["prefill_chunks"] > ps.stats["prefills"]


def test_chunked_prefill_off_for_windowed_ring_caches():
    """A window at or below max_seq can wrap within one resume chunk, so
    the scheduler prefills whole prompts there, as the reference does."""
    cfg, params, scfg = _setup("recurrentgemma-9b", max_seq=128,
                               max_new_tokens=2, prefill_chunk=4)
    ps = PagedScheduler(params, cfg, scfg, n_slots=1, device="cpu")
    assert ps._chunk is None


def test_paged_property_parity():
    """Property: for random ragged lengths, budgets and seeds the paged
    scheduler is token-identical to the slot batcher (instances shared
    across examples)."""
    cfg, params, scfg = _setup(max_new_tokens=6, eos_id=7)
    cb = ContinuousBatcher(params, cfg, scfg, n_slots=2, device="cpu")
    ps = PagedScheduler(params, cfg, scfg, n_slots=2, num_blocks=7,
                        device="cpu")

    @settings(max_examples=5, deadline=None)
    @given(seed=st.integers(0, 10 ** 6),
           n=st.integers(1, 4),
           budget_hi=st.integers(1, 6))
    def prop(seed, n, budget_hi):
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(1, cfg.vocab,
                                (int(rng.integers(1, 14)),)).astype(np.int32)
                   for _ in range(n)]
        budgets = [int(rng.integers(1, budget_hi + 1)) for _ in range(n)]
        for p, m in zip(prompts, budgets):
            cb.submit(p, max_new_tokens=m)
            ps.submit(p, max_new_tokens=m)
        ref, got = cb.run(), ps.run()
        for rid in ref:
            assert ref[rid] == got[rid], (rid, ref[rid], got[rid])

    prop()


def test_streaming_callback_and_feed():
    """``on_token`` streams every token in order; ``feed`` injects
    arrivals while the loop runs."""
    cfg, params, scfg = _setup(max_new_tokens=5)
    prompts = _ragged_prompts(4, cfg.vocab, seed=4)
    ps = PagedScheduler(params, cfg, scfg, n_slots=2, device="cpu")
    left = list(prompts)

    def feed():
        if left:
            ps.submit(left.pop(0))
        return bool(left)

    stream = []
    results = ps.run(on_token=lambda rid, tok: stream.append((rid, tok)),
                     feed=feed)
    per_req: dict = {}
    for rid, tok in stream:
        per_req.setdefault(rid, []).append(tok)
    assert per_req == results and len(results) == 4
    cb = ContinuousBatcher(params, cfg, scfg, n_slots=2, device="cpu")
    for p in prompts:
        cb.submit(p)
    assert cb.run() == results


def test_decode_block_syncs_the_host_once(monkeypatch):
    """Each decode block reads its [K, B] tokens in ONE host_sync; the
    only other syncs are the admissions' first tokens."""
    cfg, params, scfg = _setup(max_new_tokens=12)
    ps = PagedScheduler(params, cfg, scfg, n_slots=3, device="cpu")
    calls = []
    real = sched_mod.host_sync
    monkeypatch.setattr(sched_mod, "host_sync", lambda x, *, reason: (
        calls.append(reason), real(x, reason=reason))[1])
    per_block = []
    block = ps._decode_block

    def counted():
        n = len(calls)
        block()
        per_block.append(len(calls) - n)

    ps._decode_block = counted
    prompts = _ragged_prompts(5, cfg.vocab)
    for p in prompts:
        ps.submit(p)
    ps.run()
    assert per_block and set(per_block) == {1}
    assert ps.stats["decode_blocks"] == len(per_block)
    assert len(calls) == ps.stats["decode_blocks"] + ps.stats["prefills"]


# ------------------------------------------------- against the JAX package

@pytest.mark.parametrize("backend,kw", [
    ("digital", dict(n=6, max_new_tokens=10, num_blocks=None)),
    ("digital", dict(n=4, max_new_tokens=24, num_blocks=5)),
    ("kernel", dict(n=3, max_new_tokens=6, num_blocks=None)),
])
def test_paged_scheduler_equals_the_jax_scheduler(backend, kw):
    """Greedy streams and every stat equal the JAX PagedScheduler's on the
    same parameters and requests: the same control flow, the same tokens
    (``kernel`` against ``pallas`` in interpret mode); the oversubscribed
    case preempts in both."""
    jc, tc, pj, pt = _params("olmo-1b")
    if backend != "digital":
        jc = jc.with_accel(JAX_NAME[backend], ba=4, bx=4)
        tc = tc.with_accel(backend, ba=4, bx=4)
    common = dict(max_seq=48, max_new_tokens=kw["max_new_tokens"],
                  kv_block_size=8)
    prompts = _ragged_prompts(kw["n"], tc.vocab, seed=13)
    ts = PagedScheduler(pt, tc, ServeConfig(**common), n_slots=3,
                        num_blocks=kw["num_blocks"], device="cpu")
    js = JPaged(pj, jc, JServe(**common), n_slots=3,
                num_blocks=kw["num_blocks"])
    for k, p in enumerate(prompts):
        ts.submit(p, priority=k)
        js.submit(p, priority=k)
    got, want = ts.run(), js.run()
    assert got == want
    assert ts.stats == js.stats
    if kw["num_blocks"]:
        assert ts.stats["preemptions"] > 0
