"""Production dry run: every (arch x shape) cell on the production mesh,
counted, without allocating a single parameter.  Port of
``repro.launch.dryrun``.

The reference lowers and compiles each cell for 256 (or 512) simulated
devices and reads the partitioned HLO.  The port has no compiler to ask,
so it runs the cell instead, on ``meta`` tensors: it builds *rank 0's*
arguments at published widths (parameters, train state, caches, tokens,
frontend embeddings; whisper's ``cross_kv`` at the encoder's shape),
sets the recording mesh (:func:`~repro_torch.launch.mesh.
make_production_mesh`) and the :class:`~repro_torch.distributed.
sharding.ShardPolicy` as the ambient mesh, and runs the port's own mesh
form of the cell's entry point under a
:class:`~repro_torch.roofline.hlo_stats.StepCounter`:

* train: :func:`~repro_torch.train.step.build_train_step` with ``mesh=``
  and the arch's ``TRAIN_MICROBATCHES``, on rank 0's slices of the state
  (the dense decoders tensor-parallel in mode ``"2d"``: rank 0's tiles of
  every projection, its heads or query rows, its vocabulary block, each
  activation collective and column-form re-layout counted; the other
  archs with their parameters gathered whole on ``"model"`` but the
  experts);
* prefill and decode: :class:`~repro_torch.serve.engine.Engine` on the
  mesh, as it serves (each rank its tile of every compiled image on the
  quantizing backends, its rows of the batch and the cache, and
  attention split as ``models.attention.head_split`` splits it: on the
  rank's own heads of q, k, v and the KV cache in the reference's
  ``"kv"`` and ``"g"`` modes, the ``max`` of each ``wo`` input's row
  scale counted as an all-reduce; on its query rows in ``"sq"`` and its
  head dims in ``"d"``, the KV cache and whisper's cross keys and values
  then the rank's head-dim slice, each score sum of ``"d"`` (one a
  512-key chunk) and each output gather counted; MLA on the rank's q
  heads with ``w_ukv`` a local column tile, the SSD mixer on its heads
  or head dims and the RG-LRU on its width slice, their states the
  rank's share, as ``models.mixer_split`` splits them).

Each cell writes ``<out>/<arch>__<shape>__<pod1|pod2>.json`` with the
reference's keys: ``status``, ``hlo_stats`` (the counter's counts, per
rank), ``collectives`` (the counter's collectives by kind with their
``total_bytes``, and ``by_axis``; each op's bytes the larger of its
operand and its result, as the reference takes them),
``arg_bytes_per_device`` (the bytes of the tensors rank 0 is
handed), ``n_devices``, ``memory_analysis.temp_size_in_bytes`` (the
counter's peak of bytes allocated in the step beyond its arguments) and
``count_s``, the cell's wall seconds (set-up and the counted run).
Where the port replicates what XLA would shard (the 2-D training
compute of the MLA, SSD, RG-LRU, cross-attention and MoE blocks) the
counts say so: they are the port's, not the reference's.
A cell that raises is written with ``status: "error"``, as the
reference writes one; :func:`repro_torch.roofline.analysis.main` renders
the table.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod both]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import torch

BACKENDS = ("digital", "digital_int", "bpbs", "kernel")


def tree_bytes(tree) -> int:
    """Bytes of the tensors a rank holds in ``tree``: every tensor and
    compiled image, except the raw weight behind an image compiled as
    one tile (the engine releases it: the rank holds only its tile)."""
    from repro_torch.accel import CimaImage

    if tree is None:
        return 0
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, CimaImage):
        return sum(tree_bytes(t) for t in (tree.ws, tree.wq, tree.scale))
    if isinstance(tree, dict):
        img = tree.get("cima")
        tiled = isinstance(img, CimaImage) and img.tile is not None
        return sum(tree_bytes(v) for k, v in tree.items()
                   if not (tiled and k == "w"))
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


# the config's perf flags the port's models read
PERF_FLAGS = ("attn_scan_remat", "onehot_embed", "attn_bf16_probs")


def _parse_opts(opts: str, cfg):
    """``--opt`` knobs: ``mb``, the config's :data:`PERF_FLAGS` and
    ``policy``.  The reference's ``sp_residual`` raises: its sequence-
    parallel residual turns the row all-reduce into a reduce-scatter
    once the layers around it run locally, which in training waits for
    tensor-parallel compute (ROADMAP 4k, after 4g)."""
    from repro_torch.distributed.sharding import ShardPolicy

    mb, policy, kw = None, None, {}
    for kv in filter(None, opts.split(",")):
        k, v = kv.split("=")
        if k == "mb":
            mb = int(v)
        elif k in PERF_FLAGS:
            kw[k] = bool(int(v))
        elif k == "policy":
            policy = ShardPolicy(v)
        elif k == "sp_residual":
            raise ValueError("opt sp_residual: the port's models run no "
                             "sequence-parallel residual yet (ROADMAP 4k, "
                             "after tensor-parallel training, 4g)")
        else:
            raise ValueError(f"unknown opt {k}")
    return (dataclasses.replace(cfg, **kw) if kw else cfg), mb, policy


def _frontend(cfg, batch: int, device):
    if cfg.frontend == "none":
        return None
    return torch.empty((batch, cfg.frontend_seq, cfg.d_model),
                       dtype=torch.float32, device=device)


def _train(cfg, arch, shape, mesh, policy, mb, counter):
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.shapes import TRAIN_MICROBATCHES
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import build_train_step

    state = init_train_state(init_params(cfg, 0, device="meta",
                                         max_seq=shape.seq))
    specs = shd.state_specs(state, mesh, policy)
    local = shd.shard_tree(state, specs, mesh)
    del state
    batch = {"tokens": torch.empty((shape.batch, shape.seq),
                                   dtype=torch.int32, device="meta")}
    fe = _frontend(cfg, shape.batch, "meta")
    if fe is not None:
        batch["frontend_embeds"] = fe
    mb = mb or TRAIN_MICROBATCHES.get(arch, 1)
    step = build_train_step(cfg, AdamWConfig(), microbatches=mb, mesh=mesh,
                            shard_policy=policy, specs=specs)
    args = tree_bytes(local) + tree_bytes(batch)
    with counter:
        step(local, batch)
    return args, {"microbatches": mb}


def _serve(cfg, shape, mesh, policy, counter):
    from repro_torch.models import init_params
    from repro_torch.serve.engine import Engine, ServeConfig

    engine = Engine(init_params(cfg, 0, device="meta", max_seq=shape.seq),
                    cfg, ServeConfig(max_seq=shape.seq, mesh=mesh,
                                     shard_policy=policy), device="meta")
    mine = engine.data_rows(shape.batch)
    rows = mine or slice(0, shape.batch)
    n = rows.stop - rows.start
    params = tree_bytes(engine.params)
    if shape.kind == "prefill":
        tokens = torch.empty((n, shape.seq), dtype=torch.int32,
                             device="meta")
        fe = _frontend(cfg, n, "meta")
        args = params + tree_bytes((tokens, fe))
        with counter, engine.local_rows(mine):
            engine.prefill(tokens, fe)
    else:
        cache = engine.init_cache(shape.batch)
        token = torch.empty((n,), dtype=torch.int32, device="meta")
        args = params + tree_bytes((token, cache))
        with counter, engine.local_rows(mine):
            engine.decode(token, cache)
    image = {"program_images": len(engine.program.images)
             if engine.program else 0}
    return args, image


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             backend: str = "digital", out_dir: str = "artifacts/dryrun",
             extra_tag: str = "", opts: str = "") -> dict:
    """Count one cell on rank 0 of the production mesh and write its
    record; returns it."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.autoshard import use_mesh
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shapes import SHAPES, cell_supported
    from repro_torch.roofline.hlo_stats import StepCounter

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    shape = SHAPES[shape_name]
    mesh_tag = "pod2" if multi_pod else "pod1"
    tag = f"{arch}__{shape_name}__{mesh_tag}" + \
        (f"__{extra_tag}" if extra_tag else "")
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
              "backend": backend, "tag": extra_tag}
    cfg = get_config(arch)
    if backend != "digital":
        # every managed projection on the named backend
        cfg = cfg.with_accel(backend=backend)
    cfg, mb, policy = _parse_opts(opts, cfg)
    if opts:
        record["opts"] = opts
    ok, reason = cell_supported(cfg, shape_name)
    if not ok:
        record.update(status="skipped", reason=reason)
        return _write(record, tag, out_dir)

    mesh = make_production_mesh(multi_pod=multi_pod)
    counter = StepCounter()
    t0 = time.monotonic()
    with use_mesh(mesh, policy):
        if shape.kind == "train":
            args, extra = _train(cfg, arch, shape, mesh, policy, mb, counter)
        else:
            args, extra = _serve(cfg, shape, mesh, policy, counter)
    stats = counter.stats()
    # the reference's layout: by kind, then the total; and by axis
    collectives = dict(stats["collectives"],
                       total_bytes=stats["collective_bytes"],
                       by_axis=stats["collectives_by_axis"])
    record.update(
        status="ok",
        count_s=round(time.monotonic() - t0, 2),
        memory_analysis={"argument_size_in_bytes": int(args),
                         "temp_size_in_bytes": int(stats["peak_bytes"])},
        collectives=collectives,
        hlo_stats=stats,
        arg_bytes_per_device=int(args),
        n_devices=int(mesh.size_of(mesh.axis_names)),
        mesh_shape=dict(mesh.shape),
        **extra)
    return _write(record, tag, out_dir)


def _write(record: dict, tag: str, out_dir: str) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
        json.dump(record, f, indent=1)
    status = record["status"]
    extra = ""
    if status == "ok":
        fl = record["hlo_stats"]["dot_flops"]
        ko = record["hlo_stats"]["kernel_ops"]
        cb = record["hlo_stats"]["collective_bytes"]
        extra = (f" dot_flops/dev={fl:.3g} kernel_ops/dev={ko:.3g} "
                 f"coll_bytes/dev={cb:.3g} "
                 f"args/dev={record['arg_bytes_per_device'] / 2**30:.2f}GiB "
                 f"count={record['count_s']}s")
    print(f"[dryrun] {tag}: {status}{extra}", flush=True)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", default="no", choices=["no", "yes", "both"])
    ap.add_argument("--backend", default="digital", choices=BACKENDS,
                    help="accel backend for every managed projection")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--opt", default="",
                    help="perf knobs, e.g. attn_scan_remat=1,mb=4")
    args = ap.parse_args(argv)

    if args.all:
        from repro_torch.launch.shapes import all_cells

        failures = []
        pods = ["no", "yes"] if args.multi_pod == "both" else \
            [args.multi_pod]
        for arch, shape_name, _ok, _reason in all_cells():
            for mp in pods:
                mesh_tag = "pod2" if mp == "yes" else "pod1"
                out_json = os.path.join(
                    args.out, f"{arch}__{shape_name}__{mesh_tag}.json")
                if os.path.exists(out_json):
                    print(f"[dryrun] cached: {out_json}", flush=True)
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape_name,
                       "--multi-pod", mp, "--backend", args.backend,
                       "--out", args.out]
                if subprocess.run(cmd).returncode != 0:
                    failures.append((arch, shape_name, mp))
        if failures:
            print(f"[dryrun] FAILURES: {failures}", flush=True)
            sys.exit(1)
        print("[dryrun] all cells done", flush=True)
        return

    try:
        run_cell(args.arch, args.shape, args.multi_pod == "yes",
                 args.backend, args.out, args.tag, args.opt)
    except Exception:
        traceback.print_exc()
        mesh_tag = "pod2" if args.multi_pod == "yes" else "pod1"
        tag = f"{args.arch}__{args.shape}__{mesh_tag}" + \
            (f"__{args.tag}" if args.tag else "")
        _write({"arch": args.arch, "shape": args.shape, "mesh": mesh_tag,
                "backend": args.backend, "status": "error", "tag": args.tag,
                "error": traceback.format_exc()[-2000:]}, tag, args.out)
        sys.exit(1)


if __name__ == "__main__":
    main()
