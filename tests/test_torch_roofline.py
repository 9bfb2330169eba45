"""The production dry run and the roofline (``repro_torch.launch.shapes``,
``launch.dryrun``, ``launch.mesh.make_production_mesh``,
``roofline.hlo_stats``, ``roofline.analysis``) against the JAX package.

* ``SHAPES``, ``TRAIN_MICROBATCHES`` and ``cell_supported`` equal the
  reference's for all 40 (arch, shape) cells.
* The counter against the reference: on reduced olmo-1b, mamba2-130m,
  deepseek-v2-lite-16b and whisper-tiny, for ``decode_step``,
  ``prefill`` and one train step with remat on, on ``digital``, the
  port's counted ``dot_flops`` and ``dot_bytes`` equal
  ``repro.roofline.hlo_stats.analyze`` over the reference's compiled HLO
  of the same call on the same shapes.  Tolerance 0, except where XLA
  rewrites a dot (:data:`XLA_REWRITES` says where and why).
* Meta equals CPU: every count of those calls (at 2 layers) is equal on
  ``meta`` and on the CPU for ``digital``, ``digital_int`` and ``bpbs``.
  On the CPU a bank whose input planes are all zero issues no GEMM, so
  the inputs are random tokens that leave no bank all zero (a MoE config
  routes tokens to every expert).  On ``meta`` the ``kernel`` backend accounts for
  exactly the ``bpbs`` plane GEMMs: its ``dot_flops`` plus its
  ``kernel_ops`` plus the recombination of each bank's plane products
  (a dot in ``bpbs``, the kernel's epilogue on the card) is ``bpbs``'s
  ``dot_flops``, and ``kernel_ops`` is the sum of ``2 * calls * n * m *
  ba * bx`` over a CPU ``trace()``'s records.
* The recording mesh against real ranks: on a 2 x 2 mesh of spawned gloo
  ranks (``tests/torch_mesh.py::task_roofline``) rank 0's collectives
  (count and bytes, by kind and by axis) and its ``ServeMesh.stats``
  equal the recording mesh's on ``meta``, for a decode step on ``bpbs``
  served from a program, one ``"fsdp"`` train step and one ``"2d"``
  train step of reduced deepseek-v2-lite (the MoE blocks' gathers).
* ``roofline_row`` picks the reference's dominant term and useful ratio
  on one synthetic record; its times differ from the reference's only by
  the ratio of the constants.
* The CLI: one cell of ``python -m repro_torch.launch.dryrun`` ends
  ``ok`` with 256 devices and counted dots (the reference's
  ``test_dryrun_cell_end_to_end``), and deepseek-v2-lite's train_4k
  cell ends ``ok`` with its MoE blocks' collectives.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh as tm
from repro import models as jm
from repro.configs import get_config as jget
from repro.launch import shapes as jshapes
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.roofline import analysis as janalysis
from repro.roofline.hlo_stats import analyze as janalyze
from repro.train.state import init_train_state as jinit_state
from repro.train.step import build_train_step as jbuild_step
from repro_torch import accel
from repro_torch import models as tmodels
from repro_torch.configs import ALL_ARCHS
from repro_torch.configs import get_config as tget
from repro_torch.launch import shapes as tshapes
from repro_torch.distributed import sharding as tshd
from repro_torch.launch.mesh import (RecordingMesh, ServeMesh,
                                     make_production_mesh)
from repro_torch.optim.adamw import AdamWConfig as TAdamW
from repro_torch.roofline import analysis as tanalysis
from repro_torch.roofline.hlo_stats import StepCounter
from repro_torch.train.state import init_train_state as tinit_state
from repro_torch.train.step import build_train_step as tbuild_step
from repro_torch.tree import tree_map

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["olmo-1b", "mamba2-130m", "deepseek-v2-lite-16b", "whisper-tiny"]
CALLS = ["decode", "prefill", "train"]
B, S, TS, MAX_SEQ = 2, 16, 16, 64
# (arch, call) -> (dot_flops rtol, dot_bytes rtol) where XLA rewrites a
# dot.  mamba2's SSD einsums take an operand broadcast over the heads:
# XLA materialises the broadcast before the dot (more bytes, the same
# flops) and differentiates it into small dots where torch's autograd
# sums over the broadcast (0.34% of the train step's flops).  whisper's
# cross k/v projection runs the encoder output shared by the decoder
# layers: XLA folds the layers into one dot's output, torch runs a
# batched product over a stride-0 operand (the bytes of the operand
# differ, the flops do not).
XLA_REWRITES = {("mamba2-130m", "prefill"): (0.0, 0.05),
                ("mamba2-130m", "train"): (0.004, 0.14),
                ("whisper-tiny", "prefill"): (0.0, 0.01),
                ("whisper-tiny", "train"): (0.0, 0.01)}


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


def _reference_counts(arch: str, call: str, opts: tuple = ()) -> dict:
    cfg = dataclasses.replace(jget(arch).reduced(), **dict(opts))
    params = jm.init_params(cfg, jax.random.PRNGKey(0), max_seq=MAX_SEQ)
    fe = (jnp.zeros((B, cfg.frontend_seq, cfg.d_model))
          if cfg.frontend != "none" else None)
    tok = jnp.asarray(_tokens(cfg, (B, S)), jnp.int32)
    if call == "prefill":
        fn, args = (lambda p, t, f: jm.prefill(p, t, cfg, MAX_SEQ, f),
                    (params, tok, fe))
    elif call == "decode":
        cache = (jm.prefill(params, tok, cfg, MAX_SEQ, fe)[1]
                 if cfg.is_encdec else jm.init_cache(cfg, B, MAX_SEQ))
        fn, args = (lambda p, t, c: jm.decode_step(p, t, c, cfg),
                    (params, tok[:, 0], cache))
    else:
        cfg = dataclasses.replace(cfg, remat=True)
        batch = {"tokens": jnp.asarray(_tokens(cfg, (B, TS)), jnp.int32)}
        if fe is not None:
            batch["frontend_embeds"] = fe
        fn, args = jbuild_step(cfg, JAdamW()), (jinit_state(params), batch)
    return janalyze(jax.jit(fn).lower(*args).compile().as_text())


@functools.lru_cache(maxsize=None)
def port_counts(arch: str, call: str, backend: str = "digital",
                device: str = "cpu", batch: int = B,
                layers: int = 0, opts: tuple = ()) -> dict:
    """The counter's stats of ``call`` on reduced ``arch`` (cut to
    ``layers`` when given; parameters from seed 0 on the CPU, moved to
    ``device``; ``batch`` rows; ``opts`` config fields set), with every
    managed projection on ``backend``."""
    cfg = dataclasses.replace(tget(arch).reduced(), **dict(opts))
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if backend != "digital":
        cfg = cfg.with_accel(backend, ba=4, bx=4)
    params = tmodels.init_params(cfg, 0, device="cpu", max_seq=MAX_SEQ)
    params = tree_map(lambda t: t.to(device), params)
    fe = (torch.zeros((batch, cfg.frontend_seq, cfg.d_model), device=device)
          if cfg.frontend != "none" else None)
    tok = torch.as_tensor(_tokens(cfg, (batch, S)), dtype=torch.int32,
                          device=device)
    if call == "train":
        cfg = dataclasses.replace(cfg, remat=True)
        data = {"tokens": torch.as_tensor(_tokens(cfg, (batch, TS)),
                                          dtype=torch.int32, device=device)}
        if fe is not None:
            data["frontend_embeds"] = fe
        step = tbuild_step(cfg, TAdamW())
        state = tinit_state(params)
        with StepCounter() as c:
            step(state, data)
        return c.stats()
    with torch.no_grad():
        cache = (tmodels.prefill(params, tok, cfg, MAX_SEQ,
                                 frontend_embeds=fe)[1]
                 if call == "decode" and cfg.is_encdec
                 else tmodels.init_cache(cfg, batch, MAX_SEQ, device=device))
        with StepCounter() as c:
            if call == "prefill":
                tmodels.prefill(params, tok, cfg, MAX_SEQ, frontend_embeds=fe)
            else:
                tmodels.decode_step(params, tok[:, 0], cache, cfg)
    return c.stats()


# ------------------------------------------------------------------ shapes

def test_shapes_equal_reference():
    assert {k: dataclasses.astuple(v) for k, v in tshapes.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}
    assert tshapes.TRAIN_MICROBATCHES == jshapes.TRAIN_MICROBATCHES
    cells = list(tshapes.all_cells())
    assert len(cells) == 40
    for arch, shape, ok, reason in cells:
        assert (ok, reason) == jshapes.cell_supported(jget(arch), shape)


def test_production_mesh():
    for multi_pod, shape in ((False, {"data": 16, "model": 16}),
                             (True, {"pod": 2, "data": 16, "model": 16})):
        mesh = make_production_mesh(multi_pod)
        assert dict(mesh.shape) == shape
        assert mesh.axis_names == tuple(shape)
        assert mesh.device.type == "meta"
        assert all(mesh.index(a) == 0 for a in shape)
        t = torch.empty((4, 8), device="meta")
        with StepCounter() as c:
            assert mesh.all_gather(t, ("data", "model"), 1).shape == \
                (4, 2048)
            assert mesh.all_reduce(t, mesh.axis_names).shape == (4, 8)
        n = len(shape)
        assert mesh.stats == {"collectives": 2 + n,
                              "bytes": 128 + 128 * 16 + 128 * n}
        # the counter's bytes: the larger of operand and result
        hs = c.stats()
        assert hs["collectives"]["all-gather"] == {"count": 2,
                                                   "bytes": 128 * 16 * 17}
        assert hs["collectives"]["all-reduce"] == {"count": n,
                                                   "bytes": 128 * n}
        assert hs["collectives_by_axis"]["model"] == {
            "count": 2, "bytes": 128 * 16 + 128}


# ------------------------------------------------ the counter vs the HLO

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("call", CALLS)
def test_counts_match_reference_hlo(arch, call):
    ref = _reference_counts(arch, call)
    got = port_counts(arch, call)
    rtol_f, rtol_b = XLA_REWRITES.get((arch, call), (0.0, 0.0))
    assert got["dot_flops"] == pytest.approx(ref["dot_flops"], rel=rtol_f,
                                             abs=0)
    assert got["dot_bytes"] == pytest.approx(ref["dot_bytes"], rel=rtol_b,
                                             abs=0)
    assert got["dot_flops_by_dtype"] == {"float32": got["dot_flops"]}


@pytest.mark.parametrize("call", CALLS)
def test_onehot_embed_opt_counts_match_reference_hlo(call):
    """``--opt onehot_embed=1`` changes the counts: the embedding becomes
    a one-hot dot, counted as the reference's HLO counts it."""
    opts = (("onehot_embed", True),)
    ref = _reference_counts("olmo-1b", call, opts)
    got = port_counts("olmo-1b", call, opts=opts)
    assert got["dot_flops"] > port_counts("olmo-1b", call)["dot_flops"]
    assert got["dot_flops"] == ref["dot_flops"]
    assert got["dot_bytes"] == ref["dot_bytes"]


@pytest.mark.parametrize("opts, expect", [
    ("onehot_embed=1,attn_bf16_probs=1,mb=2,policy=fsdp",
     dict(onehot_embed=True, attn_bf16_probs=True, mb=2, policy="fsdp")),
    ("attn_scan_remat=1", dict(attn_scan_remat=True, mb=None, policy=None)),
    ("sp_residual=1", "sequence-parallel"),
    ("remat=1", "unknown opt"),
])
def test_dryrun_opts(opts, expect, tmp_path):
    from repro_torch.launch import dryrun

    if isinstance(expect, str):
        with pytest.raises(ValueError, match=expect):
            dryrun.run_cell("olmo-1b", "decode_32k", False,
                            out_dir=str(tmp_path), opts=opts)
        return
    cfg, mb, policy = dryrun._parse_opts(opts, tget("olmo-1b"))
    assert mb == expect.pop("mb")
    p = expect.pop("policy")
    assert (policy and policy.mode) == p
    for k, v in expect.items():
        assert getattr(cfg, k) is v


def test_dryrun_tagged_record_is_left_out_of_the_table(tmp_path):
    """``--tag`` writes a variant beside the cell's record; the table
    (``load_cells``) leaves tagged records out, as the reference's."""
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell("olmo-1b", "long_500k", False,
                          out_dir=str(tmp_path), extra_tag="probe")
    assert rec["status"] == "skipped" and rec["tag"] == "probe"
    assert (tmp_path / "olmo-1b__long_500k__pod1__probe.json").exists()
    assert tanalysis.load_cells(str(tmp_path)) == []


# ----------------------------------------------------------- meta vs CPU

# a batch whose 2 routes a token reach every one of the reduced MoE
# config's 8 experts: no expert's bank all zero on the CPU
ROWS = {"deepseek-v2-lite-16b": 16}
META_KEYS = ("dot_flops", "dot_flops_by_dtype", "dot_bytes", "result_bytes",
             "n_ops", "kernel_ops", "kernel_bytes", "kernel_calls",
             "peak_bytes", "collectives", "collective_bytes")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", ["digital", "digital_int", "bpbs"])
def test_meta_counts_equal_cpu(arch, backend):
    for call in CALLS:
        rows = ROWS.get(arch, B)
        cpu = port_counts(arch, call, backend, batch=rows, layers=2)
        meta = port_counts(arch, call, backend, device="meta", batch=rows,
                           layers=2)
        assert {k: meta[k] for k in META_KEYS} == \
            {k: cpu[k] for k in META_KEYS}, (arch, backend, call)
        assert cpu["kernel_calls"] == 0


def _recombination_flops(records) -> int:
    """The ``bpbs`` path's recombination of each bank's plane products:
    one dot of ``2 * calls * m * ba * bx`` a bank."""
    return sum(2 * r.calls * r.m * r.ba * r.bx * -(-r.n // 2304)
               for r in records)


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-v2-lite-16b"])
def test_kernel_on_meta_accounts_for_the_plane_gemms(arch):
    rows = ROWS.get(arch, B)
    for call in ("decode", "prefill"):
        meta = port_counts(arch, call, "kernel", device="meta", batch=rows)
        bpbs = port_counts(arch, call, "bpbs", batch=rows)
        with accel.trace() as records:
            port_counts(arch, call, "kernel", batch=rows)
        planes = sum(2 * r.calls * r.n * r.m * r.ba * r.bx for r in records)
        assert meta["kernel_ops"] == planes
        assert meta["kernel_calls"] == len(records)
        assert meta["dot_flops"] + meta["kernel_ops"] \
            + _recombination_flops(records) == bpbs["dot_flops"]
    train = port_counts(arch, "train", "kernel", device="meta")
    assert train["kernel_calls"] > 0


# ---------------------------------------------- recording mesh vs gloo

def test_recording_mesh_equals_real_ranks(tmp_path):
    scfg = tget("olmo-1b").reduced().with_accel("bpbs", ba=4, bx=4)
    tcfg = tget("olmo-1b").reduced()
    mcfg = tget("deepseek-v2-lite-16b").reduced()
    args = dict(serve=(scfg, tmodels.init_params(scfg, 0, device="cpu",
                                                 max_seq=32)),
                train=(tcfg, tmodels.init_params(tcfg, 1, device="cpu",
                                                 max_seq=32)),
                train_moe=(mcfg, tmodels.init_params(mcfg, 1, device="cpu",
                                                     max_seq=32)),
                opt=TAdamW(), batch=4,
                tokens=_tokens(tcfg, (4, 8)).astype(np.int32))
    real = tm.spawn("roofline", 4, tmp_path, args)[0]
    rec = tm.roofline_runs(RecordingMesh(data=2, model=2,
                                         device=torch.device("meta")),
                           args, device="meta")
    for call in ("decode", "train", "train_moe"):
        (r_stats, r_mesh), (m_stats, m_mesh) = real[call], rec[call]
        assert r_mesh["collectives"] > 0
        assert m_mesh == r_mesh, call
        for k in ("collectives", "collectives_by_axis", "collective_bytes",
                  "dot_flops", "dot_bytes"):
            assert m_stats[k] == r_stats[k], (call, k)
    # beside the parameters' gathers (a sharded axis a leaf), two a MoE
    # block: its rows over "data", its expert outputs over "model"
    params = args["train_moe"][1]
    specs = tshd.state_specs(tinit_state(params), ServeMesh(2, 2),
                             tshd.ShardPolicy("2d"))
    gathers = sum(len(tshd.sharded_axes(s))
                  for s in tshd.spec_leaves(params, specs.params))
    n_moe = sum(k == "moe" for k in mcfg.pattern())
    assert rec["train_moe"][0]["collectives"]["all-gather"]["count"] == \
        gathers + 2 * n_moe


def test_head_local_decode_cell_on_a_recording_mesh():
    """A reduced olmo-1b decode cell (4 rows, ``kernel``) run as the dry
    run runs it, on rank 0 of a recording mesh of model 2: attention on
    the rank's heads, so its arguments count half the KV cache (what the
    cache adds from 32 to 64 positions is half the unsharded cache's),
    and its collectives are the head-local step's: per layer an
    all-reduce of wo's and mlp.down's sums and one of wo's input scale
    (``max``), the gathers of mlp.gate and mlp.up, and the unembed's
    gather; no q/k/v gathers.  (``test_recording_mesh_equals_real_ranks``
    holds such a decode step's counts to a spawned rank 0's.)"""
    from repro_torch.distributed.autoshard import use_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeDef

    cfg = tget("olmo-1b").reduced().with_accel("kernel")
    mesh = RecordingMesh(data=1, model=2, device=torch.device("meta"))
    args, stats = {}, {}
    for seq in (32, 64):
        counter = StepCounter()
        with use_mesh(mesh):
            args[seq], _ = dryrun._serve(cfg, ShapeDef("d", "decode", seq, 4),
                                         mesh, None, counter)
        stats[seq] = counter.stats()
    whole = {seq: dryrun.tree_bytes(tmodels.init_cache(
        cfg, 4, seq, device="meta").layers) for seq in (32, 64)}
    assert 2 * (args[64] - args[32]) == whole[64] - whole[32]
    layers = cfg.n_layers
    col = stats[32]["collectives"]
    assert col["all-reduce"]["count"] == 3 * layers
    assert col["all-gather"]["count"] == 2 * layers + 1
    assert set(stats[32]["collectives_by_axis"]) == {"model"}


# ---------------------------------------------------------- the roofline

def _synthetic_record():
    hs = {"dot_flops": 4.0e14, "dot_flops_by_dtype": {"bfloat16": 4.0e14},
          "dot_bytes": 2.0e11, "result_bytes": 9.0e11,
          "collective_bytes": 1.5e10,
          "collectives_by_axis": {"data": {"count": 3, "bytes": 1.0e10},
                                  "model": {"count": 5, "bytes": 5.0e9}}}
    return {"arch": "olmo-1b", "shape": "train_4k", "mesh": "pod1",
            "status": "ok", "n_devices": 256, "hlo_stats": hs,
            "mesh_shape": {"data": 16, "model": 16},
            "arg_bytes_per_device": 2 ** 30,
            "memory_analysis": {"temp_size_in_bytes": 2 ** 31}}


def test_roofline_row_against_reference():
    rec = _synthetic_record()
    ours = tanalysis.roofline_row(rec)["row"]
    ref = janalysis.roofline_row(rec)["row"]
    assert ours["dominant"] == ref["dominant"] == "compute"
    assert ours["useful_ratio"] == pytest.approx(ref["useful_ratio"],
                                                 rel=1e-12)
    assert ours["compute_s"] * tanalysis.PEAK_FLOPS["bfloat16"] == \
        pytest.approx(ref["compute_s"] * janalysis.PEAK_FLOPS, rel=1e-12)
    assert ours["memory_s"] * tanalysis.HBM_BW == \
        pytest.approx(ref["memory_s"] * janalysis.HBM_BW, rel=1e-12)
    # both axes of 16 x 16 cross nodes of 8 cards
    assert ours["link"] == "network"
    assert ours["collective_s"] * tanalysis.NODE_BW == \
        pytest.approx(ref["collective_s"] * janalysis.ICI_BW, rel=1e-12)
    assert tanalysis.axis_links({"data": 2, "model": 4}) == {
        "data": "nvlink", "model": "nvlink"}
    assert tanalysis.axis_links({"data": 4, "model": 4}) == {
        "data": "network", "model": "nvlink"}
    text = tanalysis.fmt_table([tanalysis.roofline_row(rec)], "t")
    assert "| olmo-1b | train_4k |" in text and "**compute**" in text


def test_no_tpu_constant_in_the_roofline():
    src = (ROOT / "src/repro_torch/roofline/analysis.py").read_text()
    for word in ("v5e", "197e12", "819e9", "MXU", "ICI", "Pallas"):
        assert word not in src


def test_dryrun_cell_end_to_end(tmp_path):
    out = tmp_path / "dryrun"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "decode_32k", "--multi-pod", "no",
         "--out", str(out)], capture_output=True, text=True, timeout=120,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads((out / "whisper-tiny__decode_32k__pod1.json")
                     .read_text())
    assert rec["status"] == "ok"
    assert rec["n_devices"] == 256
    assert rec["hlo_stats"]["dot_flops"] > 0
    assert rec["arg_bytes_per_device"] > 0
    # one tally of the collectives: the record's are the counter's
    hs = rec["hlo_stats"]
    assert rec["collectives"]["total_bytes"] == hs["collective_bytes"]
    assert rec["collectives"]["by_axis"] == hs["collectives_by_axis"]
    assert {k: rec["collectives"][k] for k in hs["collectives"]} == \
        hs["collectives"]
    rows = [tanalysis.roofline_row(c) for c in tanalysis.load_cells(
        str(out), "pod1")]
    assert rows[0]["row"]["dominant"] in ("compute", "memory", "collective")


def test_moe_train_cell_counts(tmp_path):
    """deepseek-v2-lite's train_4k cell on pod1: counted, with the MoE
    blocks' gathers over "data" (the rows) and "model" (the expert
    outputs) among its collectives and the backward's reduce-scatters
    of the rows."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "deepseek-v2-lite-16b", "--shape", "train_4k", "--out",
         str(tmp_path)], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads((tmp_path / "deepseek-v2-lite-16b__train_4k__pod1.json")
                     .read_text())
    assert rec["status"] == "ok"
    hs = rec["hlo_stats"]
    assert rec["collectives"]["total_bytes"] == hs["collective_bytes"]
    assert rec["collectives"]["all-gather"]["count"] > 0
    assert rec["collectives"]["reduce-scatter"]["count"] > 0
    assert {"data", "model"} <= set(rec["collectives"]["by_axis"])
    assert all(a in ALL_ARCHS for a in tshapes.TRAIN_MICROBATCHES)
