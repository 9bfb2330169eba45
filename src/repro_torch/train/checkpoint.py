"""Fault-tolerant checkpointing.  Port of ``repro.train.checkpoint``.

* Atomic: written to ``step_%08d.tmp`` and renamed, so a crash mid-save
  never corrupts the latest checkpoint.
* Async: :class:`AsyncCheckpointer` snapshots the tree to host memory at
  once and writes it on a worker thread (at most one save in flight).
* The reference's on-disk format: ``step_%08d/arrays.npz`` (leaf ``i`` as
  ``a{i}``) and ``manifest.json`` with the step and the leaf names
  spelled as ``jax.tree_util.keystr`` spells them, so a checkpoint the
  JAX package wrote restores into the port and back.  Dtypes numpy lacks
  (bfloat16) are stored as float32 and cast back on restore.
* Elastic: leaves are stored whole.  On a mesh the checkpointer gathers
  each leaf from its slices, one rank writes and every rank waits for
  it (so no rank resumes from an older step); :func:`restore` with a
  spec tree cuts this rank's slices from the full arrays, so a job saved
  on one mesh shape resumes on another or on one device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import leaves_with_path, tree_map, unflatten

_KEYFILE = "manifest.json"
_STORED = (torch.float32, torch.float64, torch.int32, torch.int64,
           torch.int8, torch.uint8, torch.bool)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype not in _STORED:
        t = t.to(torch.float32)      # bf16 etc: store wide, cast back
    return t.cpu().numpy()


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    """Synchronous atomic save.  Returns the checkpoint path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = leaves_with_path(tree)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"a{i}": _to_numpy(leaf) for i, (_, leaf) in enumerate(flat)})
    with open(os.path.join(tmp, _KEYFILE), "w") as f:
        json.dump({"step": step, "names": [name for name, _ in flat],
                   "saved_at": time.time()}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


class AsyncCheckpointer:
    """Fire-and-forget saves on a worker thread; at most one in flight.
    A failed save raises from the next :meth:`save` or :meth:`wait`.

    With ``mesh`` and ``specs`` (a tree of this rank's slices and its
    spec tree) every rank of the mesh calls :meth:`save`: the leaves are
    gathered to the host whole, rank 0 writes, and the save returns on
    every rank once the checkpoint is in place."""

    def __init__(self, ckpt_dir: str, keep: int = 3, mesh=None, specs=None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.mesh, self.specs = mesh, specs
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, step: int, tree: Any):
        if self.mesh is not None:
            self._save_on_mesh(step, tree)
            return
        host_tree = tree_map(lambda t: t.detach().to("cpu", copy=True),
                             tree)                    # snapshot now
        self.wait()

        def _run():
            try:
                save(self.ckpt_dir, step, host_tree)
                gc_old(self.ckpt_dir, self.keep)
            except Exception as e:  # noqa: BLE001 - raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def _save_on_mesh(self, step: int, tree: Any) -> None:
        from repro_torch.distributed.sharding import gather_leaf

        first = self.mesh.rank == 0

        def to_host(t, spec):
            full = gather_leaf(t, spec, self.mesh)   # every rank gathers
            return full.detach().to("cpu", copy=True) if first else None

        host_tree = tree_map(to_host, tree, self.specs)
        if first:
            save(self.ckpt_dir, step, host_tree)
            gc_old(self.ckpt_dir, self.keep)
        self.mesh.barrier()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def list_checkpoints(ckpt_dir: str) -> list[tuple[int, str]]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        full = os.path.join(ckpt_dir, d)
        if d.startswith("step_") and not d.endswith(".tmp") \
                and os.path.exists(os.path.join(full, _KEYFILE)):
            out.append((int(d.split("_")[1]), full))
    return sorted(out)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    cks = list_checkpoints(ckpt_dir)
    return cks[-1][1] if cks else None


def gc_old(ckpt_dir: str, keep: int):
    cks = list_checkpoints(ckpt_dir)
    for _, path in cks[:-keep]:
        shutil.rmtree(path, ignore_errors=True)


def restore(path: str, template: Any, sharding_tree: Any = None,
            mesh=None):
    """Restore into ``template``'s structure (full shapes): each leaf
    takes its template leaf's dtype and device.  Returns ``(tree,
    step)``.  ``sharding_tree`` (a spec tree of ``template``'s
    structure) re-shards for ``mesh``: each leaf is this rank's slice of
    the stored array, the elastic-rescale path."""
    if sharding_tree is not None and mesh is None:
        raise ValueError("restore under a sharding needs its mesh")
    with open(os.path.join(path, _KEYFILE)) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        by_name = {n: data[f"a{i}"] for i, n in enumerate(manifest["names"])}
    out = []
    for name, leaf in leaves_with_path(template):
        if name not in by_name:
            raise KeyError(f"checkpoint missing leaf {name}")
        arr = by_name[name]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {name}: "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        out.append(torch.from_numpy(arr))
    if sharding_tree is not None:
        from repro_torch.distributed.sharding import local_slice, spec_leaves

        out = [local_slice(a, s, mesh).clone() for a, s in
               zip(out, spec_leaves(template, sharding_tree))]
    out = [a.to(dtype=leaf.dtype, device=leaf.device)
           for a, leaf in zip(out, (leaf for _, leaf in
                                    leaves_with_path(template)))]
    return unflatten(template, out), manifest["step"]
