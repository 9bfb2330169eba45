"""The port's bank allocator, streaming and program manager against the
JAX package's, and the cost of a streamed decode step.

Reduced olmo-1b (4 layers, d_model 128) with the reference's
``init_params`` converted key for key.  Placements, program summaries and
reload schedules are integers and exact strings: they must be equal.
Logits of resident, synchronously streamed and double-buffered programs
must be bitwise equal (streaming is accounting only).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import accel as jaccel
from repro.accel import program as jprogram
from repro.configs import get_config as jget
from repro.core import energy as JE
from repro.models import decode_step as jdecode
from repro.models import init_params as jinit
from repro.models import prefill as jprefill
from repro_torch import accel as taccel
from repro_torch.accel import program as tprogram
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.kernels import cima_mvm as K
from repro_torch.models import decode_step as tdecode
from repro_torch.models import forward as tforward
from repro_torch.models import prefill as tprefill
from repro_torch.serve import Engine as TEngine
from repro_torch.serve import ServeConfig as TServe
from repro_torch.tree import leaves_with_path

JAX_NAME = {"digital_int": "digital_int", "bpbs": "bpbs", "kernel": "pallas"}
# reduced olmo-1b at B_A = 4 holds 80 array tiles: 32 attention, 8 down,
# 16 gate, 16 up, 8 unembed (sorted keys: attention first, then down)
CAPACITIES = [None, 48, 40, 0]


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ref():
    jc = jget("olmo-1b").reduced()
    pj = jinit(jc, jax.random.PRNGKey(0), max_seq=32)
    pt = params_from_jax(jax.tree.map(np.asarray, pj), "cpu")
    toks = np.random.default_rng(0).integers(1, jc.vocab, (2, 8))
    return jc, tget("olmo-1b").reduced(), pj, pt, toks.astype(np.int32)


def _cfgs(ref, backend):
    return (ref[0].with_accel(JAX_NAME[backend], ba=4, bx=4),
            ref[1].with_accel(backend, ba=4, bx=4))


def _placement(pl):
    return (pl.footprint.path, pl.footprint.tag, pl.footprint.kind,
            pl.footprint.n, pl.footprint.m, pl.footprint.copies,
            pl.spec.ba, pl.spec.bx, pl.partition, pl.devices, pl.tiles,
            pl.segments, pl.resident, pl.overlap, pl.data_shards)


def test_allocator_full_array_reload_is_18k_cycles():
    for mod in (tprogram, jprogram):
        assert mod.image_tiles(2304, 64, 4) == 1
        assert mod.image_segments(2304, 64, 4) == 768
        assert mod.image_segments(2304, 64, 4) * mod.segment_cycles() == \
            JE.matrix_load_cycles() == 18432
    for n, m, ba in ((27, 128, 1), (1152, 10, 4), (16384, 1024, 1),
                     (2048, 50304, 4), (8192, 2048, 4)):
        assert tprogram.image_tiles(n, m, ba) == jprogram.image_tiles(n, m, ba)
        assert tprogram.image_segments(n, m, ba) == \
            jprogram.image_segments(n, m, ba)
    assert tprogram.segment_dma_words() == jprogram.segment_dma_words()


def test_allocator_capacity_streams_overflow_and_charges_loads():
    """A streamed image's dispatch carries its load, and energy_summary
    charges the full-array reload; a resident one charges none."""
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.normal(size=(4, 2304)).astype(np.float32))
    w = torch.from_numpy(r.normal(size=(2304, 64)).astype(np.float32))
    spec = taccel.ExecSpec(backend="kernel", ba=4, bx=4)
    img = dataclasses.replace(tprogram._compile_image(w, spec, "full"),
                              resident=False)
    with taccel.trace() as records:
        taccel.matmul(x, w, spec, image=img)
    r0 = records[0]
    assert r0.program and r0.loads == 1 and r0.load_segments == 768
    es = taccel.energy_summary(records, vdd=0.85)
    assert es["load_cycles"] == JE.matrix_load_cycles()
    assert es["load_pj"] > 0
    with taccel.trace() as records:
        taccel.matmul(x, w, spec,
                      image=dataclasses.replace(img, resident=True))
    assert records[0].loads == 0
    assert taccel.energy_summary(records)["load_cycles"] == 0


@pytest.mark.parametrize("double_buffer", [True, False])
@pytest.mark.parametrize("capacity", CAPACITIES)
def test_plan_and_summary_equal_reference(ref, capacity, double_buffer):
    jc, tc = _cfgs(ref, "kernel")
    jf = jaccel.model_footprint(ref[2], jc)
    tf = taccel.model_footprint(ref[3], tc)
    assert [dataclasses.astuple(f) for f in tf] == \
        [dataclasses.astuple(f) for f in jf]
    jplan = jaccel.plan_allocation(jf, jc.policy, capacity,
                                   double_buffer=double_buffer)
    tplan = taccel.plan_allocation(tf, tc.policy, capacity,
                                   double_buffer=double_buffer)
    assert list(tplan) == list(jplan)
    assert [_placement(p) for p in tplan.values()] == \
        [_placement(p) for p in jplan.values()]
    jp = jaccel.build_program(ref[2], jc, capacity_chips=capacity,
                              double_buffer=double_buffer)
    tp = taccel.build_program(ref[3], tc, capacity_chips=capacity,
                              double_buffer=double_buffer)
    assert tp.summary() == jp.summary()
    assert tp.stream_schedule() == jp.stream_schedule()
    for k, ti in tp.images.items():
        ji = jp.images[k]
        assert (ti.tiles, ti.segments, ti.resident, ti.overlap, ti.copies,
                ti.partition, ti.devices, ti.data_shards) == \
            (ji.tiles, ji.segments, ji.resident, ji.overlap, ji.copies,
             ji.partition, ji.devices, ji.data_shards)


def test_allocator_first_fit_residency_on_model(ref):
    """A tight budget keeps the leading images resident and streams the
    tail; a traced forward charges every layer's copy of a streamed
    stack, one record per layer."""
    _, tc = _cfgs(ref, "bpbs")
    pt = ref[3]
    total = taccel.build_program(pt, tc).tiles_total
    capped = taccel.build_program(pt, tc, capacity_chips=total // 2)
    assert capped.tiles_used <= total // 2
    streamed = [i for i in capped.images.values() if not i.resident]
    assert streamed and capped.summary()["streamed"]
    assert capped.reload_cycles_per_pass() == sum(
        i.segments * i.copies for i in streamed) * tprogram.segment_cycles()
    pp = taccel.install_program(pt, capped, tc)
    with taccel.trace() as records, torch.inference_mode():
        tprefill(pp, torch.from_numpy(ref[4][:1, :4]).long(), tc, 16)
    assert sum(r.loads * r.load_segments for r in records) == \
        capped.reload_segments_per_pass()
    assert sum(r.load_prologue for r in records) == 1


def test_mesh_arguments_wait_for_the_multi_device_slice(ref):
    """The allocator's mesh arithmetic is the reference's (placements and
    summary at 2 x 2 and 1 x 4), while executing a partition waits for
    the multi-device slice: a program built for a mesh runs whole on one
    device, its logits bitwise the unpartitioned program's, its records
    carrying the compiled partition."""
    jc, tc = _cfgs(ref, "bpbs")
    fps = taccel.model_footprint(ref[3], tc)
    jfps = jaccel.model_footprint(ref[2], jc)
    for data, model in ((2, 2), (1, 4)):
        tplan = taccel.plan_allocation(fps, tc.policy, 48,
                                       model_shards=model, data_shards=data)
        jplan = jaccel.plan_allocation(jfps, jc.policy, 48,
                                       model_shards=model, data_shards=data)
        assert [_placement(p) for p in tplan.values()] == \
            [_placement(p) for p in jplan.values()]
        assert {p.partition for p in tplan.values()} == {"col", "row"}
        assert taccel.build_program(
            ref[3], tc, capacity_chips=48, model_shards=model,
            data_shards=data).summary() == jaccel.build_program(
            ref[2], jc, capacity_chips=48, model_shards=model,
            data_shards=data).summary()
    toks = torch.from_numpy(ref[4]).long()
    flat = taccel.install_program(ref[3], taccel.build_program(ref[3], tc),
                                  tc)
    meshed = taccel.install_program(
        ref[3], taccel.build_program(ref[3], tc, model_shards=4), tc)
    with torch.inference_mode():
        want = tforward(flat, toks, tc)[0]
        with taccel.trace() as records:
            got = tforward(meshed, toks, tc)[0]
    assert torch.equal(got, want)
    assert {(r.devices, r.partition) for r in records} == \
        {(4, "col"), (4, "row")}


def _nudge(params, step: int):
    """A deterministic weight update of every matrix (an optimizer step
    stand-in the port can run before it has an optimizer)."""
    def go(node):
        if isinstance(node, dict):
            return {k: go(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(go(v) for v in node)
        if node.ndim >= 2:
            g = np.random.default_rng(step).normal(size=node.shape)
            return node + 0.05 * torch.from_numpy(g.astype(np.float32))
        return node
    return go(params)


def test_program_manager_invalidation_after_optimizer_step(ref):
    """Moved weights make the images stale: after invalidate() the
    manager rebuilds once, and the rebuild equals a fresh compile."""
    _, tc = _cfgs(ref, "digital_int")
    params = ref[3]
    mgr = taccel.ProgramManager(tc)
    prog0 = mgr.ensure(params)
    assert mgr.ensure(params) is prog0
    moved = _nudge(params, 1)
    mgr.invalidate()
    prog1 = mgr.ensure(moved)
    assert prog1 is not prog0 and prog1.version == prog0.version + 1
    assert mgr.ensure(moved) is prog1
    fresh = taccel.build_program(moved, tc)
    for key in prog1.images:
        assert torch.equal(prog1.images[key].ws, fresh.images[key].ws)
    assert any(not torch.equal(prog0.images[k].ws, prog1.images[k].ws)
               for k in prog0.images)
    on = taccel.ProgramManager(tc, capacity_chips=0).ensure(params)
    off = taccel.ProgramManager(tc, capacity_chips=0,
                                double_buffer=False).ensure(params)
    assert on.double_buffer and not off.double_buffer
    assert all(i.overlap and not i.resident for i in on.images.values())
    assert not any(i.overlap for i in off.images.values())


@pytest.mark.parametrize("backend", ["digital_int", "kernel"])
def test_program_bitwise_parity_resident_sync_overlap(ref, backend):
    """Resident, streamed-synchronous and double-buffered programs give
    bitwise equal prefill and decode logits; the overlapped trace's wall
    cycles drop below the synchronous trace's by exactly its hidden load
    cycles, at equal reload energy."""
    _, tc = _cfgs(ref, backend)
    pt = ref[3]
    toks = torch.from_numpy(ref[4]).long()
    progs = {"resident": taccel.build_program(pt, tc),
             "sync": taccel.build_program(pt, tc, capacity_chips=0,
                                          double_buffer=False),
             "overlap": taccel.build_program(pt, tc, capacity_chips=0)}
    out, es = {}, {}
    for name, prog in progs.items():
        pp = taccel.install_program(pt, prog, tc)
        with taccel.trace() as recs, torch.inference_mode():
            logits, cache = tprefill(pp, toks, tc, 32)
            dec, _ = tdecode(pp, torch.argmax(logits, -1), cache, tc)
        out[name] = (logits, dec)
        es[name] = taccel.energy_summary(recs)
    for name in ("sync", "overlap"):
        assert torch.equal(out[name][0], out["resident"][0])
        assert torch.equal(out[name][1], out["resident"][1])
    assert es["resident"]["load_cycles"] == 0
    assert es["overlap"]["load_cycles"] == es["sync"]["load_cycles"] > 0
    assert es["overlap"]["load_pj"] == es["sync"]["load_pj"]
    assert es["overlap"]["load_cycles_hidden"] > 0
    assert es["sync"]["load_cycles_hidden"] == 0
    assert es["overlap"]["total_cycles"] == (
        es["sync"]["total_cycles"] - es["overlap"]["load_cycles_hidden"])


def test_program_summary_and_schedule_surface_streaming(ref):
    _, tc = _cfgs(ref, "digital_int")
    prog = taccel.build_program(ref[3], tc, capacity_chips=0)
    s = prog.summary()
    assert s["double_buffer"] and len(s["streamed_images"]) == \
        len(s["streamed"]) > 0
    assert s["excluded_from_sharding"] == [] and s["excluded_count"] == 0
    rows = prog.stream_schedule()
    assert rows == s["streamed_images"]
    assert all(r["overlap"] and r["reload_cycles_per_pass"] > 0
               for r in rows)
    assert sum(r["reload_cycles_per_pass"] for r in rows) == \
        prog.reload_cycles_per_pass()
    sync = taccel.build_program(ref[3], tc, capacity_chips=0,
                                double_buffer=False)
    assert not any(r["overlap"] for r in sync.stream_schedule())


_MEASURED = dict(sparsity=None, planes_skipped=None, planes_total=None)


def test_streamed_decode_step_cost_equals_reference(ref):
    """One decode step of a program that streams its tail (capacity 40
    of 80 tiles), traced in both packages.

    The reference runs the layer stack as one ``lax.scan`` traced under
    ``vmapped(n_layers)``: one record per projection with ``calls``,
    ``loads`` and ``copies`` times 4, and ``sparsity=None`` inside the
    scan (its activations are tracers).  The port loops over the layers
    and emits one record per layer, each charging its own copy.  So the
    records must agree summed per tag, the pass must carry exactly one
    prologue, and ``energy_summary`` with the measured fields cleared on
    both sides must equal the reference's to rel 1e-12 (the port adds
    the per-layer pJ in another order)."""
    jc, tc = _cfgs(ref, "kernel")
    jp = jaccel.build_program(ref[2], jc, capacity_chips=40)
    tp = taccel.build_program(ref[3], tc, capacity_chips=40)
    pj = jaccel.install_program(ref[2], jp, jc)
    pt = taccel.install_program(ref[3], tp, tc)
    toks = ref[4]
    lj, cj = jprefill(pj, jnp.asarray(toks), jc, 16)
    with torch.inference_mode():
        lt, ct = tprefill(pt, torch.from_numpy(toks).long(), tc, 16)
    nxt = np.asarray(jnp.argmax(lj, -1))
    assert np.array_equal(nxt, torch.argmax(lt, -1).numpy())
    with jaccel.trace(vdd=1.2) as jr:
        jdecode(pj, jnp.asarray(nxt), cj, jc)
    with taccel.trace(vdd=1.2) as tr, torch.inference_mode():
        tdecode(pt, torch.from_numpy(np.array(nxt)).long(), ct, tc)

    def per_tag(records):
        out = {}
        for r in records:
            row = out.setdefault(r.tag, [0, 0, 0, 0, 0])
            for i, v in enumerate((r.calls, r.loads, r.copies,
                                   r.load_prologue, r.loads * r.load_segments)):
                row[i] += v
        return out

    assert len(tr) == 4 * 7 + 1 and len(jr) == 7 + 1
    assert per_tag(tr) == per_tag(jr)
    assert sum(r.load_prologue for r in tr) == 1
    assert {r.tag for r in tr if r.loads} == set(jp.summary()["streamed"])
    assert all(r.sparsity is not None for r in tr)     # measured eagerly
    for readout in ("adc", "abn"):
        ts = taccel.energy_summary(
            [dataclasses.replace(r, **_MEASURED) for r in tr],
            vdd=tr.vdd, readout=readout)
        js = jaccel.energy_summary(
            [dataclasses.replace(r, **_MEASURED) for r in jr],
            vdd=jr.vdd, readout=readout)
        assert ts["vdd"] == js["vdd"] == 1.2
        for k in ("total_cycles", "load_cycles", "load_cycles_hidden",
                  "load_cycles_exposed", "input_sparsity", "plane_skip"):
            assert ts[k] == js[k], k
        for k in ("total_pj", "load_pj", "post_pj"):
            assert ts[k] == pytest.approx(js[k], rel=1e-12, abs=0.0), k
        assert set(ts["by_tag"]) == set(js["by_tag"])
        for tag, row in ts["by_tag"].items():
            want = js["by_tag"][tag]
            for k in ("mvms", "cycles", "load_cycles", "load_cycles_hidden",
                      "load_cycles_exposed"):
                assert row[k] == want[k], (tag, k)
            for k in ("pj", "post_pj"):
                assert row[k] == pytest.approx(want[k], rel=1e-12,
                                               abs=0.0), (tag, k)


def test_engine_streams_with_bitwise_equal_tokens(ref):
    """ServeConfig.cima_chips builds a streaming program; the tokens are
    bitwise those of the all-resident engine, and an untraced generate
    records nothing."""
    _, tc = _cfgs(ref, "kernel")
    toks = torch.from_numpy(ref[4])
    gens = {}
    for chips in (None, 40):
        eng = TEngine(ref[3], tc, TServe(max_seq=32, max_new_tokens=5,
                                         cima_chips=chips), device="cpu")
        assert eng.program.capacity_tiles == chips
        gens[chips] = eng.generate(toks)
    assert eng.program.summary()["streamed"]
    np.testing.assert_array_equal(gens[40], gens[None])
    logits, cache = eng.prefill(toks)
    with taccel.trace(vdd=1.2) as tr:
        eng.decode(torch.argmax(logits, -1), cache)
    assert len(tr) == 4 * 7 + 1 and sum(r.load_prologue for r in tr) == 1
    assert taccel.energy_summary(tr)["load_cycles"] == \
        eng.program.reload_cycles_per_pass()


def test_image_planes_in_column_blocks_are_the_same_bits(ref, monkeypatch):
    """``build_program`` decomposes a weight into planes a block of
    columns at a time (a 256,000-column unembed's float32 planes would
    not fit beside the model); any block width gives the bits of the
    whole-matrix decomposition, ragged last block included."""
    from repro_torch.core.bpbs import weight_planes

    _, tc = _cfgs(ref, "kernel")
    spec = tc.policy.resolve("unembed", kind="unembed")
    w = ref[3]["embed"]["table"].T
    qw = tprogram.quantize(w, spec.ba, spec.coding, axis=1)
    whole = weight_planes(qw.q, spec.bpbs()).permute(0, 2, 1).to(torch.int8)
    monkeypatch.setattr(K, "PLANE_ELEMENTS", 37 * w.shape[0])
    assert w.shape[1] % 37
    img = tprogram._compile_image(w, spec, "embed")
    assert torch.equal(img.ws, whole)
    assert img.ws.dtype == torch.int8 and img.ws.is_contiguous()


# ------------------------------------------------------------ MoE images

@pytest.fixture(scope="module")
def moe_ref():
    jc = jget("deepseek-v2-lite-16b").reduced()
    pj = jinit(jc, jax.random.PRNGKey(0), max_seq=32)
    pt = params_from_jax(jax.tree.map(np.asarray, pj), "cpu")
    toks = np.random.default_rng(1).integers(1, jc.vocab, (2, 6))
    return jc, tget("deepseek-v2-lite-16b").reduced(), pj, pt, toks


def test_moe_strip_install_roundtrip(moe_ref):
    """The port of ``test_strip_program_roundtrip`` on deepseek: install
    writes the experts' images as ``moe["cima"] = {"gate", "up",
    "down"}`` (stacked [layers, experts, N, B_A, M]) at the reference's
    install paths, and ``strip_program`` removes that container whole:
    the stripped tree is the original, and it runs."""
    jc, tc = (moe_ref[0].with_accel("bpbs", ba=4, bx=4),
              moe_ref[1].with_accel("bpbs", ba=4, bx=4))
    pt = moe_ref[3]
    prog = taccel.build_program(pt, tc)
    assert sorted(prog.images) == sorted(
        jaccel.build_program(moe_ref[2], jc).images)
    pp = taccel.install_program(pt, prog, tc)
    moe = pp["stack"]["scanned"]["u0"]["moe"]
    assert sorted(moe["cima"]) == ["down", "gate", "up"]
    n_rep, e = tc.n_layers - tc.first_k_dense, tc.n_experts
    assert tuple(moe["cima"]["gate"].ws.shape) == \
        (n_rep, e, tc.d_model, 4, tc.moe_d_ff)
    assert moe["cima"]["gate"].copies == n_rep * e
    stripped = taccel.strip_program(pp)
    assert "cima" not in stripped["stack"]["scanned"]["u0"]["moe"]
    want, got = leaves_with_path(pt), leaves_with_path(stripped)
    assert [k for k, _ in got] == [k for k, _ in want]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(got, want))
    with torch.inference_mode():
        lg, _ = tforward(stripped, torch.from_numpy(moe_ref[4]).long(), tc)
    assert bool(torch.isfinite(lg).all())


def test_partial_moe_policy_mixes_program_and_fly(moe_ref):
    """The port of ``test_partial_moe_policy_mixes_program_and_fly``: a
    policy that keeps ``moe.down`` digital compiles only the gate/up
    expert images; the grouped dispatch serves those two from the program
    and runs down digital, with the raw params' logits bit for bit."""
    pol = taccel.PrecisionPolicy(
        rules=(("path:moe.down", taccel.ExecSpec(backend="digital")),),
        default=taccel.ExecSpec(backend="digital_int", ba=4, bx=4))
    tc = dataclasses.replace(moe_ref[1], policy=pol)
    pt = moe_ref[3]
    program = taccel.build_program(pt, tc)
    tags = {i.tag for i in program.images.values()}
    assert {"moe.gate", "moe.up"} <= tags and "moe.down" not in tags
    pp = taccel.install_program(pt, program, tc)
    assert sorted(pp["stack"]["scanned"]["u0"]["moe"]["cima"]) == \
        ["gate", "up"]
    toks = torch.from_numpy(moe_ref[4]).long()
    with taccel.trace() as tr, torch.inference_mode():
        lg_img, _ = tforward(pp, toks, tc)
    with torch.inference_mode():
        lg_fly, _ = tforward(pt, toks, tc)
    assert torch.equal(lg_img, lg_fly)
    served = {r.tag: r.program for r in tr}
    assert served["moe.gate"] and served["moe.up"]
    assert not served["moe.down"]


def test_compile_image_writes_each_copy_in_place_same_bits():
    """``_compile_image`` writes every copy of a stacked [layers, experts,
    N, M] weight into its slot of one preallocated image: the planes,
    int16 grid and scales of each copy equal that copy compiled alone,
    per channel and per tensor."""
    w = torch.randn(2, 3, 40, 24, generator=torch.Generator().manual_seed(4))
    for per_channel in (True, False):
        ts = taccel.ExecSpec(backend="kernel", ba=4, bx=4,
                             per_channel=per_channel)
        img = tprogram._compile_image(w, ts, "w")
        assert tuple(img.ws.shape) == (2, 3, 40, 4, 24)
        assert img.ws.dtype == torch.int8 and img.ws.is_contiguous()
        assert img.wq.dtype == torch.int16 and img.copies == 6
        for i in range(2):
            for j in range(3):
                one = tprogram._compile_image(w[i, j], ts, "w")
                layer = img.layer(i)
                assert layer.copies == 3
                for f in ("ws", "wq", "scale"):
                    assert torch.equal(getattr(img, f)[i, j],
                                       getattr(one, f)), (f, i, j)
                    assert torch.equal(getattr(layer.layer(j), f),
                                       getattr(one, f))
