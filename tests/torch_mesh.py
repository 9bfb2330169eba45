"""Spawned ``gloo`` process groups for the port's mesh tests.

:func:`spawn` starts one plain Python process per rank, as ``torchrun``
would, each running ``python tests/torch_mesh.py <task> <rank> <world>
<dir>``: the rank joins a ``gloo`` group through a ``file://`` rendezvous
under ``dir`` (no port, so parallel test workers never clash), runs the
task on the CPU and writes its results to ``dir/rank<r>.pt``.  The ranks
import ``repro_torch`` only: the JAX reference runs in the test process.

Tasks take the job's arguments (``dir/args.pt``) and return a dict of
tensors, arrays and plain values.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
MESHES = ((1, 2), (1, 4), (2, 2))     # (data, model)


def spawn(task: str, world: int, workdir, args: dict,
          timeout: int = 300) -> list:
    """Run ``task`` on ``world`` spawned ranks; returns each rank's
    results, in rank order.  A failing rank fails the call with every
    rank's output."""
    return start(task, world, workdir, args, timeout)()


def start(task: str, world: int, workdir, args: dict, timeout: int = 300):
    """:func:`spawn` without waiting: returns the call that waits for the
    ranks and returns their results."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save(args, workdir / "args.pt")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, task, str(r), str(world), str(workdir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO) for r in range(world)]

    def wait() -> list:
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
        if any(p.returncode for p in procs):
            raise AssertionError("\n".join(
                f"--- rank {r} exited {p.returncode}:\n{o}"
                for r, (p, o) in enumerate(zip(procs, outs))))
        return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
    return wait


def meshes(world: int, device: str = "cpu"):
    """Every mesh of MESHES that fits the job, over its first ranks, on
    ``gloo``: ``(shape, mesh or None)`` on every rank (None outside the
    mesh)."""
    from repro_torch.launch.mesh import make_serve_mesh

    for data, model in MESHES:
        if data * model <= world:
            yield (data, model), make_serve_mesh(
                data, model, backend="gloo", device=device,
                ranks=list(range(data * model)))


# ------------------------------------------------------------------ tasks

def _operands(args):
    r = np.random.default_rng(args["seed"])
    x = r.normal(size=args["x_shape"]).astype(np.float32)
    w = r.normal(size=args["w_shape"]).astype(np.float32)
    post = {k: r.normal(size=(args["w_shape"][1],)).astype(np.float32)
            for k in ("scale", "bias")}
    return x, w, post


def task_shard(args) -> dict:
    """``sharded_program_matmul`` on every case of ``args["cases"]``
    (``(mesh, tag, backend, bank_n, with_post, tiled)``): the result of
    dispatch under the mesh, and of ``sharded_program_matmul`` called
    directly; both on a whole image (``tiled`` False: sliced per rank)
    or on the rank's compiled tile.  Under ``"local"``, for each
    whole-bank case on a compiled tile, with a per-tensor and a per-row
    input scale
    (``case + (per_row,)``): dispatch's gathered result and its local
    form's (a column tile's own columns; a row tile on the rank's N range
    of the input)."""
    from repro_torch import accel
    from repro_torch.accel.program import (_compile_image, partition_for,
                                           tile_bounds)
    from repro_torch.accel.shard import sharded_program_matmul
    from repro_torch.core.datapath import Postreduce
    from repro_torch.distributed.autoshard import use_mesh

    x, w, post_regs = _operands(args)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    post = Postreduce(scale=torch.from_numpy(post_regs["scale"]),
                      bias=torch.from_numpy(post_regs["bias"]),
                      act="relu", saturate=True)
    out = {}
    for shape, mesh in meshes(args["world"]):
        if mesh is None:
            continue
        for tag, backend, bank_n, with_post, tiled in args["cases"]:
            # "whole": per-device rows are whole banks
            spec = accel.ExecSpec(backend=backend, ba=4, bx=4, tag=tag,
                                  bank_n=(w.shape[0] // shape[1]
                                          if bank_n == "whole" else bank_n))
            part = partition_for(tag, w.shape[0], w.shape[1], shape[1])
            img = _compile_image(wt, spec, "p", shards=shape[1],
                                 partition=part,
                                 tile=mesh.index("model") if tiled else None)
            p = post if with_post else None
            with torch.inference_mode(), use_mesh(mesh):
                y = accel.matmul(xt, wt, spec, image=img, post=p)
                y_direct = sharded_program_matmul(xt, spec, img, mesh,
                                                  post=p)
            key = (shape, tag, backend, spec.bank_n, with_post, tiled)
            out[key] = (y, y_direct)
            if bank_n != "whole" or not tiled:
                continue
            xl = xt
            if part == "row":
                xl = xt[:, slice(*tile_bounds(w.shape[0], shape[1],
                                              mesh.index("model")))]
            for per_row in (False, True):
                with torch.inference_mode(), use_mesh(mesh), \
                        accel.override(x_per_row=per_row):
                    out.setdefault("local", {})[key + (per_row,)] = (
                        accel.matmul(xt, wt, spec, image=img, post=p),
                        accel.matmul(xl, wt, spec, image=img, post=p,
                                     local=part))
    return out


def task_mesh(args) -> dict:
    """Each mesh's coordinates, group collectives and counts, and the
    refusals of a mesh that does not fit the job."""
    from repro_torch.launch.mesh import make_host_mesh, make_serve_mesh

    rank = torch.distributed.get_rank()
    out = {}
    for shape, mesh in meshes(args["world"]):
        if mesh is None:
            out[shape] = None
            continue
        t = torch.tensor([[float(rank), 1.0]])
        out[shape] = dict(
            coords=mesh.coords, shape=dict(mesh.shape),
            axis_names=mesh.axis_names,
            model_sum=mesh.all_reduce(t, "model"),
            data_sum=mesh.all_reduce(t, "data"),
            model_cat=mesh.all_gather(t, "model", dim=-1),
            data_cat=mesh.all_gather(t, "data", dim=0),
            stats=dict(mesh.stats))
    for data, model in ((3, 1), (2, 4)):
        try:
            make_serve_mesh(data, model, backend="gloo", device="cpu")
        except ValueError as e:
            out[f"refused {data}x{model}"] = str(e)
    host = make_host_mesh(2, backend="gloo", device="cpu")
    out["host"] = (dict(host.shape), host.coords)
    return out


def kv_heads(tree) -> set:
    """The kv-head dims of every KV cache (or paged KV pool) in a cache
    tree."""
    return {heads for heads, _ in kv_dims(tree)}


def kv_dims(tree) -> set:
    """The (heads, head dim) of every KV cache (or paged KV pool) in a
    cache tree."""
    from repro_torch.models.attention import KVCache

    if isinstance(tree, KVCache):
        return {tuple(int(n) for n in t.shape[-2:]) for t in tree}
    if isinstance(tree, dict):
        tree = list(tree.values())
    if not isinstance(tree, (list, tuple)):
        return set()
    return set().union(set(), *map(kv_dims, tree))


def attention_chunks(keys: int, chunk: int = 512) -> int:
    """The score sums of one ``"d"`` attention call over ``keys`` keys:
    one on the dense path (up to ``2 * chunk`` keys), one a chunk on the
    chunked path (``models.attention.sdpa``)."""
    return 1 if keys <= 2 * chunk else -(-keys // chunk)


def reckoned_collectives(records, local=(), split=None,
                         gathers: int = 0) -> Counter:
    """A decode step's model-axis collectives by ``(kind, axis, op)``,
    reckoned from its ``(tag, partition)`` records: a column tile's
    gather but for the local ones (``local``), a row tile's sum, one
    ``max`` of a local row tile's input scale (``wo``'s where attention
    ran on the rank's heads); where attention ran on the rank's head
    dims or query rows (``split``: the tag of each attention call's
    ``wo`` to its mode and its keys), one score sum a chunk in ``"d"``
    and the output's gather; and the split mixers' own gathers
    (``gathers``)."""
    want = Counter()
    if gathers:
        want["all-gather", "model", None] += gathers
    for tag, part in records:
        if part == "col" and tag not in local:
            want["all-gather", "model", None] += 1
        elif part == "row":
            want["all-reduce", "model", "sum"] += 1
            if tag in local or (tag == "attn.o" and local):
                want["all-reduce", "model", "max"] += 1
        if split and tag in split:
            mode, keys = split[tag]
            if mode == "d":
                want["all-reduce", "model", "sum"] += attention_chunks(keys)
            want["all-gather", "model", None] += 1
    return want


def decode_step_counts(engine, prompts) -> dict:
    """One traced decode step on the engine's rows of ``prompts`` after
    their prefill: the ``(tag, partition)`` of each record, and each
    collective's count by ``(kind, axis, op)`` as the mesh reported it
    (``StepCounter.collectives_by_op``)."""
    from repro_torch import accel
    from repro_torch.roofline.hlo_stats import StepCounter

    rows = engine.data_rows(prompts.shape[0])
    with engine.local_rows(rows):
        logits, cache = engine.prefill(prompts if rows is None
                                       else prompts[rows])
        tok = torch.argmax(logits, dim=-1)
        with accel.trace() as records, StepCounter() as counter:
            engine.decode(tok, cache)
    return dict(records=[(r.tag, r.partition) for r in records],
                collectives={k: v["count"] for k, v in
                             counter.collectives_by_op.items()})


def serve_all(params, cfg, scfg, prompts, requests, n_slots: int,
              device="cpu") -> dict:
    """Everything the serving tests compare, on one config and (maybe
    meshed) ServeConfig: ``generate``'s tokens, prefill logits on the
    config's backend and under ``digital_int``, the kernel route's
    tokens, the per-tag calls and loads of a traced ``generate``, the
    streams of ``ContinuousBatcher`` and ``PagedScheduler`` on
    ``requests`` (``(prompt, budget)`` pairs), the kv heads of the dense,
    slot and paged caches, and one decode step's records and
    collectives."""
    from repro_torch import accel
    from repro_torch.serve import ContinuousBatcher, Engine, PagedScheduler

    engine = Engine(params, cfg, scfg, device)
    prompts = torch.as_tensor(prompts, device=engine.device)
    with accel.trace() as records:
        out = {"tokens": engine.generate(prompts)}
    out["logits"] = engine.prefill(prompts)[0].cpu()
    with accel.override(backend="digital_int"):
        out["logits_digital_int"] = engine.prefill(prompts)[0].cpu()
    with accel.override(backend="kernel"):
        out["tokens_kernel"] = engine.generate(prompts)
    calls: dict = {}
    for r in records:
        c = calls.setdefault(r.tag, [0, 0, 0])
        c[0] += 1
        c[1] += r.calls
        c[2] += r.loads
    out["trace"] = calls
    out["partitions"] = sorted({(r.tag, r.partition, r.devices)
                                for r in records})
    out["heads"] = dict(
        dense=kv_heads(engine.init_cache(n_slots).layers),
        slot=kv_heads(engine.prefill_single(
            np.asarray(requests[0][0]))[1].layers))
    out["decode"] = decode_step_counts(engine, prompts)
    for name, server in (("batcher", ContinuousBatcher),
                         ("paged", PagedScheduler)):
        srv = server(params, cfg, scfg, n_slots, device=device)
        rids = [srv.submit(p, max_new_tokens=m) for p, m in requests]
        res = srv.run()
        out[name] = [res[r] for r in rids]
        if name == "paged":
            out["heads"]["paged"] = kv_heads(srv.paged.pools)
    if engine.program is not None:
        out["image_bytes"] = sum(
            t.numel() * t.element_size()
            for img in engine.program.images.values()
            for t in (img.ws, img.wq, img.scale))
    return out


def greedy_gaps(engine, prompts) -> np.ndarray:
    """The top-2 logit gap [B, T] at each step of a greedy ``generate``
    of ``prompts`` (where a near-tie may turn a token)."""
    logits, cache = engine.prefill(torch.as_tensor(prompts,
                                                   device=engine.device))
    gaps = []
    for t in range(engine.scfg.max_new_tokens):
        if t:
            logits, cache = engine.decode(tok, cache)
        top = torch.topk(logits.float(), 2, dim=-1).values
        gaps.append(top[:, 0] - top[:, 1])
        tok = torch.argmax(logits, dim=-1)
    return torch.stack(gaps, dim=1).cpu().numpy()


def _mode(split) -> str:
    return split.mode if split is not None else "whole"


def split_sdpa_cases(mesh, keys=(40, 1100)) -> dict:
    """``attention.split_sdpa`` of this rank's ``"sq"`` and ``"d"``
    shares against ``sdpa`` whole on the same seeded q, k, v (9 q and
    3 kv heads of 32 dims, 4 causal queries at the end of ``keys``: the
    dense path and the chunked one), under ``mesh``: (whole, split) by
    (mode, keys)."""
    from repro_torch.distributed.autoshard import use_mesh
    from repro_torch.models.attention import HeadSplit, sdpa, split_sdpa

    gen = torch.Generator().manual_seed(0)
    m, k = mesh.size("model"), mesh.index("model")
    out = {}
    for n in keys:
        q = torch.randn(2, 4, 9, 32, generator=gen)
        kk = torch.randn(2, n, 3, 32, generator=gen)
        vv = torch.randn(2, n, 3, 32, generator=gen)
        kw = dict(causal=True, q_offset=n - 4, dtype=torch.float32)
        whole = sdpa(q, kk, vv, **kw)
        for mode, size in (("sq", 4), ("d", 32)):
            lo, hi = k * size // m, (k + 1) * size // m
            dims = slice(lo, hi) if mode == "d" else slice(None)
            with use_mesh(mesh):
                got = split_sdpa(HeadSplit(mode, 9, 3, 0, 3, lo, hi), q,
                                 kk[..., dims], vv[..., dims], **kw)
            out[mode, n] = (whole, got)
    return out


def serve_sqd(params, cfg, digital_cfg, scfg, prompts, requests,
              n_slots: int, device="cpu") -> dict:
    """What the ``"sq"`` / ``"d"`` serving tests compare, on one config
    whose kv heads and GQA group the model axis does not divide, on its
    backend and on ``digital_cfg`` (maybe meshed ServeConfig): the split
    of each call kind; greedy ``generate`` of ``prompts`` (even: an
    ``"sq"`` prefill on 1 x 2) and of ``prompts[:, :-1]`` (odd: ``"d"``)
    and the even prefill's logits; ``digital_cfg``'s prefill logits of
    both and one decode step's after the odd prefill; the (heads, dim)
    of the dense, slot, paged and cross caches; one decode step's
    records and collectives; ``split_sdpa_cases``; and the streams of
    ``ContinuousBatcher`` and ``PagedScheduler`` (not for an
    encoder-decoder config, which it refuses; also in 4-token prefill
    chunks, whose resumed chunks run "sq" on the "d" cache) on
    ``requests`` beside each request's solo ``generate``.  Off a mesh
    (the unsharded results these are held to) the top-2 gaps of both
    greedy runs take the place of the decode step, the split cases, the
    streams and the solo runs."""
    from repro_torch.models.attention import cross_split, head_split
    from repro_torch.serve import ContinuousBatcher, Engine, PagedScheduler

    engine = Engine(params, cfg, scfg, device)
    even = torch.as_tensor(prompts, device=engine.device)
    odd = even[:, :-1]
    kinds = {"prefill_even": even.shape[1], "prefill_odd": odd.shape[1],
             "decode": 1}
    with engine._scope():
        modes = {k: _mode(head_split(cfg, n)) for k, n in kinds.items()}
        if cfg.is_encdec:
            modes.update({f"cross_{k}": _mode(cross_split(cfg, n))
                          for k, n in kinds.items()})
            modes["encoder"] = _mode(head_split(cfg, cfg.frontend_seq))
    out = {"modes": modes,
           "tokens": {"sq": engine.generate(even), "d": engine.generate(odd)},
           "logits": {"sq": engine.prefill(even)[0].cpu()}}
    dengine = Engine(params, digital_cfg, scfg, device)
    logits, cache = dengine.prefill(odd)
    out["digital"] = {"sq": dengine.prefill(even)[0].cpu(),
                      "d": logits.cpu(),
                      "decode": dengine.decode(torch.argmax(logits, -1),
                                               cache)[0].cpu()}
    dense = engine.init_cache(n_slots)
    slot = engine.prefill_single(np.asarray(requests[0][0]))[1]
    out["dims"] = dict(dense=kv_dims(dense.layers), slot=kv_dims(slot.layers))
    if cfg.is_encdec:
        out["dims"].update(
            cross_dense={tuple(t.shape[-2:]) for t in dense.cross_kv},
            cross_slot={tuple(t.shape[-2:]) for t in slot.cross_kv},
            cross_prefill={tuple(t.shape[-2:])
                           for t in engine.prefill(even)[1].cross_kv})
    if scfg.mesh is None:
        out["gaps"] = {"sq": greedy_gaps(engine, even),
                       "d": greedy_gaps(engine, odd)}
        return out
    out["decode"] = decode_step_counts(engine, odd)
    out["split_sdpa"] = split_sdpa_cases(scfg.mesh)
    out["solo"] = [Engine(params, cfg, dataclasses.replace(
        scfg, max_new_tokens=m), device).generate(np.asarray(p)[None])[0]
        .tolist() for p, m in requests]
    servers = [("batcher", ContinuousBatcher, scfg)]
    if not cfg.is_encdec:
        servers += [("paged", PagedScheduler, scfg),
                    ("paged_chunked", PagedScheduler,
                     dataclasses.replace(scfg, prefill_chunk=4))]
    for name, server, sc in servers:
        srv = server(params, cfg, sc, n_slots, device=device)
        rids = [srv.submit(p, max_new_tokens=m) for p, m in requests]
        res = srv.run()
        out[name] = [list(res[r]) for r in rids]
        if name == "paged":
            out["dims"]["paged"] = kv_dims(srv.paged.pools)
    return out


def mixer_modes(cfg) -> dict:
    """The split of each mixer the config has, in the ambient scope:
    ``(mode, lo, hi, local)`` (``models.mixer_split``), or ``"whole"``."""
    from repro_torch.models.mixer_split import (lru_split, mla_split,
                                                ssd_split)

    kinds = set(cfg.pattern())
    found = {"mla": (cfg.mla, mla_split), "ssd": ("ssm" in kinds, ssd_split),
             "lru": ("rec" in kinds, lru_split)}
    return {k: tuple(fn(cfg)) if fn(cfg) is not None else "whole"
            for k, (has, fn) in found.items() if has}


def state_shapes(tree) -> dict:
    """The shapes of a cache tree's recurrent states and latent caches,
    by ``"<kind>.<field>"`` (the batch dim included)."""
    from repro_torch.models.attention import MLACache
    from repro_torch.models.rglru import LRUState
    from repro_torch.models.ssm import SSMState

    out: dict = {}

    def walk(t):
        for kind, cls in (("ssm", SSMState), ("lru", LRUState),
                          ("mla", MLACache)):
            if isinstance(t, cls):
                for field, leaf in zip(cls._fields, t):
                    out.setdefault(f"{kind}.{field}", set()).add(
                        tuple(int(n) for n in leaf.shape))
                return
        if isinstance(t, dict):
            t = list(t.values())
        if isinstance(t, (list, tuple)):
            for x in t:
                walk(x)
    walk(tree)
    return out


def serve_mixer(params, cfg, scfg, prompts, device="cpu") -> dict:
    """What the split-mixer tests compare, on one config and (maybe
    meshed) ServeConfig: each mixer's split in the engine's scope, the
    shapes of its states and latent caches, greedy ``generate`` on the
    config's backend, the logits of the prefill and of one decode step
    after it on ``digital_int`` (the program's tiles) and on ``digital``
    (no tiles: no projection local), and one traced decode step's
    records and collectives (:func:`decode_step_counts`)."""
    from repro_torch import accel
    from repro_torch.serve import Engine

    engine = Engine(params, cfg, scfg, device)
    prompts = torch.as_tensor(prompts, device=engine.device)
    with engine._scope():
        modes = mixer_modes(cfg)
    out = {"modes": modes,
           "shapes": state_shapes(engine.init_cache(prompts.shape[0])
                                  .layers),
           "tokens": engine.generate(prompts)}
    # digital: no program, so no tiles (an engine of its own: a mesh
    # engine keeps no raw weight behind a tile)
    for backend, eng in (("digital_int", engine), ("digital", Engine(
            params, cfg.with_accel("digital"), scfg, device))):
        with accel.override(backend=backend):
            logits, cache = eng.prefill(prompts)
            step = eng.decode(torch.argmax(logits, -1), cache)[0]
        out[backend] = {"prefill": logits.cpu(), "decode": step.cpu()}
    out["decode"] = decode_step_counts(engine, prompts)
    return out


def task_mixers(args) -> dict:
    """:func:`serve_mixer` of each config of ``args["cases"]`` (name to
    (config, params)) on a 1 x 2 mesh of the job's two ranks."""
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.serve import ServeConfig

    mesh = make_serve_mesh(1, 2, backend="gloo", device="cpu")
    return {name: serve_mixer(params, cfg,
                              ServeConfig(mesh=mesh, **args["serve"]),
                              args["prompts"])
            for name, (cfg, params) in args["cases"].items()}


def serve_streams(params, cfg, scfg, requests, n_slots: int,
                  device="cpu") -> dict:
    """The streams of ``ContinuousBatcher`` and ``PagedScheduler`` on
    ``requests`` (``(prompt, budget)`` pairs) over ``n_slots`` slots,
    each request's solo ``generate``, and each mixer's split in the
    engine's scope."""
    from repro_torch.serve import ContinuousBatcher, Engine, PagedScheduler

    engine = Engine(params, cfg, scfg, device)
    with engine._scope():
        out = {"modes": mixer_modes(cfg)}
    out["solo"] = [Engine(params, cfg, dataclasses.replace(
        scfg, max_new_tokens=m), device).generate(np.asarray(p)[None])[0]
        .tolist() for p, m in requests]
    for name, server in (("batcher", ContinuousBatcher),
                         ("paged", PagedScheduler)):
        srv = server(params, cfg, scfg, n_slots, device=device)
        rids = [srv.submit(p, max_new_tokens=m) for p, m in requests]
        res = srv.run()
        out[name] = [list(res[r]) for r in rids]
    return out


def _pair_meshes(world: int, device: str) -> list:
    """A 1 x 2 gloo mesh over each pair of ranks of the job (made on
    every rank, in one order; None outside it)."""
    from repro_torch.launch.mesh import make_serve_mesh

    return [make_serve_mesh(1, 2, backend="gloo", device=device,
                            ranks=[lo, lo + 1])
            for lo in range(0, world - 1, 2)]


def task_serve(args) -> dict:
    """:func:`serve_all` of each config in ``args["configs"]`` on every
    mesh of the job (its ServeConfig ``args["serve"]`` updated by the
    config's ``args["serve_by"]`` entry), and ``ServeConfig.from_tuned``
    on the 2 x 2 mesh; :func:`serve_sqd` of each config in
    ``args["sqd"]`` (its ``cfg``, ``digital`` config and ``params``) and
    :func:`serve_streams` of each in ``args["streams"]`` (name to
    (config, params)) on 1 x 2.  The 1 x 2 cases take the pairs of ranks
    in turn, so two run at once on 4 ranks: a case's results are on the
    ranks of its mesh only."""
    from repro_torch.serve import ServeConfig
    from repro_torch.tune import TunedConfig

    device = args.get("device", "cpu")
    pairs = _pair_meshes(args["world"], device)
    sqd = args.get("sqd", {})
    streams = args.get("streams", {})
    out = {}
    for shape, mesh in meshes(args["world"], device):
        cases = [name for name in args["configs"]
                 if shape in args["meshes"][name]]
        if shape == (1, 2):
            cases = [name for i, name in enumerate(
                cases + list(sqd) + list(streams))
                if pairs[i % len(pairs)] is not None]
            mesh = next((m for m in pairs if m is not None), None)
        if mesh is None:
            continue
        for name in cases:
            scfg = ServeConfig(mesh=mesh, **{
                **args["serve"], **args.get("serve_by", {}).get(name, {})})
            if shape == (1, 2) and name in streams:
                cfg, params = streams[name]
                out[(shape, name)] = serve_streams(
                    params, cfg, scfg, args["requests"], args["n_slots"],
                    device)
                continue
            if name in sqd:
                out[(shape, name)] = serve_sqd(
                    sqd[name]["params"], sqd[name]["cfg"],
                    sqd[name]["digital"], scfg, args["prompts"],
                    args["requests"], args["n_slots"], device)
                continue
            cfg, params = args["configs"][name]
            out[(shape, name)] = serve_all(params, cfg, scfg,
                                           args["prompts"], args["requests"],
                                           args["n_slots"], device)
        if shape == (2, 2):
            cfg, params = args["configs"][args["tuned_config"]]
            tuned = TunedConfig(policy=cfg.policy, capacity_chips=None,
                                data_shards=2, model_shards=2)
            scfg = ServeConfig.from_tuned(tuned, mesh=mesh, **args["serve"])
            from repro_torch.serve import Engine

            engine = Engine(params, cfg, scfg, device=device)
            out["tuned"] = (engine.generate(torch.as_tensor(args["prompts"])),
                            scfg.shard_policy)
    return out


def _train_meshes(world: int, shapes, device: str = "cpu") -> dict:
    """A gloo mesh over the first ranks for each of ``shapes`` that fits
    the job (made on every rank, in one order; None outside it)."""
    from repro_torch.launch.mesh import make_serve_mesh

    return {(d, m): make_serve_mesh(d, m, backend="gloo", device=device,
                                    ranks=list(range(d * m)))
            for d, m in shapes if d * m <= world}


@contextlib.contextmanager
def recorded_dispatch():
    """Yields a list that gets ``(gate_idx, keep)`` of every MoE dispatch
    run in the scope, ``keep`` in token order (assignment ``t * k + j``
    is token t's j-th expert)."""
    from repro_torch.models import moe

    seen, dispatch = [], moe.dispatch

    def recording(gate_idx, e, cap):
        out = dispatch(gate_idx, e, cap)
        order, keep = out[0], out[3]
        in_tokens = torch.empty_like(keep)
        in_tokens[order] = keep
        seen.append((gate_idx.detach().clone(), in_tokens))
        return out

    moe.dispatch = recording
    try:
        yield seen
    finally:
        moe.dispatch = dispatch


def expert_grads_whole(grads, mesh, policy):
    """``grads`` with each expert leaf's blocks gathered from the ranks
    that compute them (:func:`~repro_torch.distributed.sharding.
    expert_block`): in mode ``"2d"`` a rank's expert gradient is whole on
    its own experts only, and zero on the others."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.tree import leaves_with_path, unflatten

    out = []
    for name, g in leaves_with_path(grads):
        if any(f"['{k}']" in name for k in ("w_gate", "w_up", "w_down")):
            axes, lo, n = shd.expert_block(g.shape, mesh, policy)
            if axes:
                g = mesh.all_gather(g.narrow(g.ndim - 3, lo, n), axes,
                                    g.ndim - 3)
        out.append(g)
    return unflatten(grads, out)


def tp_view(params, param_specs, mesh):
    """The parameters a rank of a tensor-parallel step computes with:
    each leaf's ``"model"`` slice under its spec, whole on the other
    axes (what the step's gather over the fsdp axes gives)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.tree import tree_map

    return tree_map(lambda t, s: shd.slice_axes(t, s, mesh, ("model",)),
                    params, param_specs)


def train_case(cfg, params, mesh, mode: str, data_cfg, opt_cfg, steps: int,
               comp_cfg=None, device: str = "cpu") -> dict:
    """``steps`` mesh train steps of ``params`` on ``mesh`` in ``mode``:
    per step the loss, aux, gradient norm and this rank's state; before
    the first, this rank's rows (global row ids) with their logits (and
    the MoE dispatches of that forward, :func:`recorded_dispatch`), the
    loss's metrics and the gradient summed over the dp axes (expert
    leaves whole, :func:`expert_grads_whole`), both at ``params``, and
    this rank's slices of the compressed reduced gradient and error
    (``compress_sharded``) next to the full reduced gradient and error
    they slice.  In a tensor-parallel step (mode ``"2d"`` on a dense
    decoder) the forward and the gradient run on the rank's ``"model"``
    slices (:func:`tp_view`), and the vocabulary blocks of the logits
    and the slices of the gradient are gathered over ``"model"``."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.distributed import autoshard
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import forward, loss_fn
    from repro_torch.optim.compression import compress_sharded
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import (build_train_step, tensor_parallel,
                                        value_and_grad)
    from repro_torch.tree import tree_map

    policy = shd.ShardPolicy(mode)
    params = tree_map(lambda t: t.to(device), params)
    state = init_train_state(params, comp_cfg is not None)
    specs = shd.state_specs(state, mesh, policy)
    batch = make_batch(data_cfg, 0, device)
    b = batch["tokens"].shape[0]
    bspec = shd.batch_specs(batch, mesh, b, policy)["tokens"]
    ids = shd.local_slice(torch.arange(b), bspec, mesh)
    mine = {k: shd.local_slice(v, bspec, mesh) for k, v in batch.items()}
    dp = policy.dp_axes(mesh)
    tp = tensor_parallel(cfg, mesh, policy, specs.params, params)
    view = tp_view(params, specs.params, mesh) if tp else params
    with torch.no_grad(), autoshard.global_batch(mesh, policy, tp), \
            recorded_dispatch() as dispatches:
        logits = forward(view, mine["tokens"], cfg)[0]
    with autoshard.global_batch(mesh, policy, tp):
        (_, metrics), grads = value_and_grad(
            lambda p: loss_fn(p, mine, cfg), view)
    if tp:
        # a rank holds its vocabulary block of the logits (all of them
        # where the axis does not divide the vocabulary) and its model
        # slice of each leaf's gradient: gathered for the comparison
        if logits.shape[-1] < cfg.vocab:
            logits = mesh.all_gather(logits, "model", -1)
        grads = tree_map(lambda g, s: shd.gather_leaf(g, s, mesh,
                                                      ("model",)),
                         grads, specs.params)
    grads = expert_grads_whole(tree_map(lambda g: mesh.all_reduce(g, dp),
                                        grads), mesh, policy)
    out = dict(rows=ids, logits=logits, grad=grads, dispatches=dispatches,
               loss0=metrics["loss"], aux0=metrics["aux"], specs=specs)
    if comp_cfg is not None:
        err = tree_map(lambda g: 0.01 * g.flip(-1), grads)
        out["comp_full"] = (grads, err)
        out["comp_slices"] = compress_sharded(
            shd.shard_tree(grads, specs.params, mesh),
            shd.shard_tree(err, specs.params, mesh), comp_cfg.bits,
            specs.params, mesh)
    step = build_train_step(cfg, opt_cfg, comp_cfg, mesh=mesh,
                            shard_policy=policy, specs=specs)
    st = shd.shard_tree(state, specs, mesh)
    out["steps"] = []
    for s in range(steps):
        st, m = step(st, make_batch(data_cfg, s, device))
        out["steps"].append(dict(loss=float(m["loss"]),
                                 aux=float(m["aux"]),
                                 grad_norm=float(m["grad_norm"]),
                                 tokens=float(m["tokens"]), state=st))
    out["clock"] = step.clock.steps
    out["forms"] = dict(step.forms)
    out["coords"] = mesh.coords
    return out


def task_train(args) -> dict:
    """Every case of ``args``: ``cases`` ((mesh, mode, config, steps,
    compression) -> :func:`train_case`), ``psum`` (``compress_psum`` of
    each rank's gradient and error over each of ``psum_axes`` at each
    bit width, on the 2 x 2 mesh) and ``trainer`` (``train(mesh=)``
    uninterrupted, crashed and resumed on 2 x 2, the crash resumed on
    1 x 2)."""
    from repro_torch.optim.compression import compress_psum

    device = args.get("device", "cpu")
    shapes = sorted({c[0] for c in args["cases"]} | {(2, 2), (1, 2)})
    meshes = _train_meshes(args["world"], shapes, device)
    out = {}
    for key in args["cases"]:
        shape, mode, name, steps, comp = key
        if meshes.get(shape) is None:
            continue
        cfg, params = args["configs"][name]
        out[key] = train_case(cfg, params, meshes[shape], mode,
                              args["data"], args["opt"], steps, comp,
                              device)
    mesh = meshes.get((2, 2))
    if mesh is not None and "psum" in args:
        out["gather"] = _gather_checks(mesh)
        t = torch.tensor([[float(mesh.rank), -float(mesh.rank)]])
        s0 = dict(mesh.stats)
        out["collectives"] = dict(
            max_data=mesh.all_reduce(t, "data", op="max"),
            max_both=mesh.all_reduce(t, ("data", "model"), op="max"),
            sum_both=mesh.all_reduce(t, ("data", "model")),
            cat_both=mesh.all_gather(t, ("data", "model"), dim=0),
            counted=mesh.stats["collectives"] - s0["collectives"],
            counted_bytes=mesh.stats["bytes"] - s0["bytes"])
        g, e = args["psum"][mesh.rank]
        g = {k: torch.from_numpy(v) for k, v in g.items()}
        e = {k: torch.from_numpy(v) for k, v in e.items()}
        for axes in args["psum_axes"]:
            for bits in args["psum_bits"]:
                out[("psum", axes, bits)] = compress_psum(g, e, axes, bits,
                                                          mesh=mesh)
    if "trainer" in args:
        out["trainer"] = _trainer_runs(args["trainer"], meshes)
    return out


def task_train_tp(args) -> dict:
    """Every case of ``args["cases"]`` ((mesh, config, steps) ->
    :func:`train_case` in mode "2d", on the config's ``data_of`` entry
    where it has one, else ``data``), on the 1 x 2 mesh of ranks 0-1 and
    the 2 x 2 of all four; and, where ``args`` holds their operands, on
    1 x 2 the operators' checks (:func:`_tp_operator_checks`)."""
    shapes = sorted({c[0] for c in args["cases"]} | {(1, 2)})
    meshes = _train_meshes(args["world"], shapes)
    out = {}
    for key in args["cases"]:
        shape, name, steps = key
        if meshes.get(shape) is None:
            continue
        cfg, params = args["configs"][name]
        data = args.get("data_of", {}).get(name, args["data"])
        out[key] = train_case(cfg, params, meshes[shape], "2d", data,
                              args["opt"], steps)
    if meshes[(1, 2)] is not None and "ce" in args:
        out["ops"] = _tp_operator_checks(meshes[(1, 2)], args["ce"],
                                         args["col_form"])
    return out


def _tp_operator_checks(mesh, ce, col_form) -> dict:
    """On 1 x 2, inside a tensor-parallel ``global_batch`` scope, each
    operator differentiated through ``(y * w).sum()`` (``w`` = arange
    times rank + 1): ``reduce`` of ``[[rank, 1]]``, ``gather(...,
    partial=True)`` of it over "model"; the column form
    (``accel.matmul(..., tile="col-form")``) on this rank's N block and
    rows of ``col_form``'s ``(x, w, spec)``, differentiated through
    ``(y * g).sum()`` with ``g`` the rank's arange as above, with the
    collectives of its forward and of its backward apart; and
    ``vocab_nll`` of this rank's vocabulary block of ``ce``'s logits.
    Each: the result, the gradient(s) and the collectives it took."""
    from repro_torch.accel import matmul
    from repro_torch.distributed import autoshard
    from repro_torch.distributed.sharding import ShardPolicy
    from repro_torch.models.model import vocab_nll

    out = {}
    with autoshard.global_batch(mesh, ShardPolicy("2d"), tp=True):
        for name in ("reduce", "gather_partial"):
            t = torch.tensor([[float(mesh.rank), 1.0]], requires_grad=True)
            c0 = mesh.stats["collectives"]
            y = {"reduce": lambda: autoshard.reduce(t),
                 "gather_partial": lambda: autoshard.gather(
                     t, "model", 0, partial=True)}[name]()
            w = torch.arange(y.numel(), dtype=torch.float32).reshape(
                y.shape) * (mesh.rank + 1)
            (y * w).sum().backward()
            out[name] = (y.detach(), t.grad, mesh.stats["collectives"] - c0)
        x, w, spec = col_form
        n = x.shape[-1] // mesh.size("model")
        lo = mesh.rank * n
        xb = torch.from_numpy(x[:, lo:lo + n]).requires_grad_()
        wb = torch.from_numpy(w[lo:lo + n]).requires_grad_()
        c0 = mesh.stats["collectives"]
        y = matmul(xb, wb, spec, tile="col-form")
        c1 = mesh.stats["collectives"]
        g = torch.arange(y.numel(), dtype=torch.float32).reshape(
            y.shape) * (mesh.rank + 1)
        (y * g).sum().backward()
        out["col_form"] = (y.detach(), xb.grad, wb.grad, c1 - c0,
                           mesh.stats["collectives"] - c1)
        logits, targets = (torch.from_numpy(a) for a in ce)
        v = logits.shape[-1] // mesh.size("model")
        mine = logits[..., mesh.rank * v:(mesh.rank + 1) * v].clone()
        mine.requires_grad_()
        nll = vocab_nll(mine, targets)
        nll.sum().backward()
        out["vocab_nll"] = (nll.detach(), mine.grad)
    return out


def _gather_checks(mesh) -> dict:
    """On 2 x 2: ``autoshard.gather`` of this rank's ``[[rank, 1]]`` over
    "data" and over "model" in mode "2d" and over both in "fsdp", and
    ``sum_grad`` over "model", each differentiated through ``(y * w)
    .sum()`` with ``w`` = 0, 1, 2, ... times (rank + 1): the result, the
    gradient and the collectives the forward and backward issued."""
    from repro_torch.distributed import autoshard
    from repro_torch.distributed.sharding import ShardPolicy

    out = {}
    cases = [("2d", ("data",), "gather"), ("2d", ("model",), "gather"),
             ("fsdp", ("data", "model"), "gather"),
             ("2d", ("model",), "sum_grad")]
    for mode, axes, fn in cases:
        with autoshard.global_batch(mesh, ShardPolicy(mode)):
            t = torch.tensor([[float(mesh.rank), 1.0]], requires_grad=True)
            c0 = mesh.stats["collectives"]
            y = (autoshard.gather(t, axes, 0) if fn == "gather"
                 else autoshard.sum_grad(t, axes))
            w = torch.arange(y.numel(), dtype=torch.float32).reshape(
                y.shape) * (mesh.rank + 1)
            (y * w).sum().backward()
            out[(mode, axes, fn)] = (y.detach(), t.grad,
                                     mesh.stats["collectives"] - c0)
    return out


def task_quant(args) -> dict:
    """``quantize_input`` of this rank's rows of ``args["x"]`` inside
    ``global_batch`` on a ``world x 1`` mesh, for each ``(coding, bx)``
    of ``args["grids"]``: the grid, the scale and the collectives it
    took."""
    from repro_torch.accel import ExecSpec
    from repro_torch.accel.backends import quantize_input
    from repro_torch.distributed import autoshard
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_serve_mesh

    device = args.get("device", "cpu")
    mesh = make_serve_mesh(args["world"], 1, backend="gloo", device=device)
    rows = shd.local_slice(torch.from_numpy(args["x"]).to(device),
                           ("data",), mesh)
    out = {}
    for coding, bx in args["grids"]:
        spec = ExecSpec(backend="bpbs", bx=bx, coding=coding)
        c0 = mesh.stats["collectives"]
        with autoshard.global_batch(mesh):
            qx = quantize_input(rows, spec)
        out[(coding, bx)] = (qx.q, qx.scale,
                             mesh.stats["collectives"] - c0)
    return out


def roofline_runs(mesh, args, device: str = "cpu") -> dict:
    """Counted steps on ``mesh`` (a real rank's or a
    :class:`~repro_torch.launch.mesh.RecordingMesh`): a decode step of the
    ``args["serve"]`` config served from its program (each rank its tile,
    its rows of the batch), and one ``"fsdp"`` train step of the
    ``args["train"]`` config.  Each maps to (the counter's stats, the
    collectives and bytes ``mesh.stats`` counted in the step), and with
    ``args["train_moe"]`` one ``"2d"`` train step of that MoE config."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.roofline.hlo_stats import StepCounter
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import build_train_step
    from repro_torch.tree import tree_map

    def counted(fn):
        s0 = dict(mesh.stats)
        with StepCounter() as c:
            fn()
        return c.stats(), {k: mesh.stats[k] - s0[k] for k in s0}

    out = {}
    cfg, params = args["serve"]
    params = tree_map(lambda t: t.to(device), params)
    engine = Engine(params, cfg, ServeConfig(max_seq=32, mesh=mesh),
                    device=device)
    b = args["batch"]
    rows = engine.data_rows(b)
    cache = engine.init_cache(b)
    tok = torch.as_tensor(args["tokens"][:, 0]).to(device)[rows]

    def decode():
        with engine.local_rows(rows):
            engine.decode(tok, cache)

    out["decode"] = counted(decode)
    cfg, params = args["train"]
    policy = shd.ShardPolicy("fsdp")
    state = init_train_state(tree_map(lambda t: t.to(device), params))
    specs = shd.state_specs(state, mesh, policy)
    step = build_train_step(cfg, args["opt"], mesh=mesh, shard_policy=policy,
                            specs=specs)
    local = shd.shard_tree(state, specs, mesh)
    batch = {"tokens": torch.as_tensor(args["tokens"]).to(device)}
    out["train"] = counted(lambda: step(local, batch))
    if "train_moe" in args:
        cfg, params = args["train_moe"]
        policy = shd.ShardPolicy("2d")
        state = init_train_state(tree_map(lambda t: t.to(device), params))
        specs = shd.state_specs(state, mesh, policy)
        step = build_train_step(cfg, args["opt"], mesh=mesh,
                                shard_policy=policy, specs=specs)
        local = shd.shard_tree(state, specs, mesh)
        out["train_moe"] = counted(lambda: step(local, batch))
    return out


def task_roofline(args) -> dict:
    """:func:`roofline_runs` on the 2 x 2 mesh of the job."""
    from repro_torch.launch.mesh import make_serve_mesh

    mesh = make_serve_mesh(2, 2, backend="gloo", device="cpu")
    return roofline_runs(mesh, args)


def _trainer_runs(t: dict, meshes: dict) -> dict:
    """``train(mesh=)`` on 2 x 2: uninterrupted, then crashed at
    ``crash`` and resumed; the crash's checkpoints copied before the
    resume and resumed on 1 x 2 (its own copy)."""
    import shutil

    from repro_torch.distributed.sharding import ShardPolicy
    from repro_torch.train.trainer import CrashInjected, TrainerConfig, train

    root = Path(t["root"])
    quiet = lambda s: None                                # noqa: E731

    def run(mesh, name, crash=None):
        tcfg = TrainerConfig(total_steps=t["total"],
                             ckpt_dir=str(root / name), ckpt_every=2,
                             log_every=100, crash_at_step=crash)
        return train(t["cfg"], t["data"], t["opt"], tcfg, log_fn=quiet,
                     mesh=mesh, shard_policy=ShardPolicy(t["mode"]),
                     device="cpu")

    out = {}
    mesh = meshes[(2, 2)]
    if mesh is not None:
        out["ref"] = run(mesh, "ref")[1]
        try:
            run(mesh, "crash", t["crash"])
            out["crashed"] = False
        except CrashInjected:
            out["crashed"] = True
        if mesh.rank == 0:
            for name in ("crash_1x2", "crash_1x1"):
                shutil.copytree(root / "crash", root / name)
        out["resumed"] = run(mesh, "crash")[1]
    mesh = meshes[(1, 2)]
    if mesh is not None:
        out["resumed_1x2"] = run(mesh, "crash_1x2")[1]
    return out


def main():
    task, rank, world, workdir = sys.argv[1:5]
    rank, world, workdir = int(rank), int(world), Path(workdir)
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{workdir / 'store'}", rank=rank,
        world_size=world)
    args = torch.load(workdir / "args.pt", weights_only=False)
    args["world"] = world
    out = globals()[f"task_{task}"](args)
    torch.save(out, workdir / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    main()
