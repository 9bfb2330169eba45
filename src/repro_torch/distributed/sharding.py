"""Divisibility-aware sharding rules (DP / FSDP / TP / EP).  Port of
``repro.distributed.sharding``.

Every rule is a *candidate list* per tensor dimension; an axis is
assigned only when the dimension is divisible by it and the axis is not
already used on another dimension of the same tensor.  A spec is a tuple
with one entry per leading dimension: an axis name, a tuple of axis
names or None (replicated), trailing Nones dropped, the analogue of the
reference's ``PartitionSpec`` (``tuple(P(...))`` is the same tuple).
:func:`local_slice` cuts a rank's part of a tensor under its spec.

Layout conventions (DESIGN.md §6):

* batch           -> ("pod", "data")   pure DP
* weight matrices -> 2-D: TP ("model") on the parallel dim, FSDP
                     ("data") on the other
* experts         -> EP: expert dim on "model", then FSDP on d_model
* caches          -> batch on the DP axes + the largest divisible dim on
                     "model"

The serving engine applies the image rules (each rank compiles only its
tile) and the ``"data"`` entries of the cache rules (each data shard
holds its batch rows).  Its KV caches split over ``"model"`` on the kv
heads where attention runs on the rank's own heads
(``models.attention.head_split``, the reference's ``"kv"`` mode), and
on the head dim where a decode step runs on the rank's head dims
(``"d"``; whisper's cross keys and values too); other activations, and
the weights and caches outside the images, stay whole on the model
axis.  A training step on a mesh computes the
experts of its :func:`expert_block` (EP on ``"model"`` in mode
``"2d"``).  In mode ``"2d"`` the dense decoders (:func:`tp_config`)
train tensor-parallel, as the reference's step under these specs does:
each rank gathers its parameter slices over the fsdp axes alone
(:func:`gather_tree` with ``axes``) and computes with its ``"model"``
slice of every leaf that has one (:func:`splits_on_model`); the
vocabulary and SSD's ``in_proj``, where the axis does not divide them,
are used whole (:data:`WHOLE_LEAVES`).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, NamedTuple, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class ShardPolicy:
    """Distribution policy, carried explicitly through configs.

    ``mode``: ``"2d"`` (TP on "model" + FSDP/DP on "data") or ``"fsdp"``
    (no tensor parallelism: batch over all axes, parameters ZeRO-3 over
    ("data", "model")).  ``data_shards`` declares the intended size of
    the mesh's ``"data"`` axis for serving; the engine validates it
    against the actual mesh."""

    mode: str = "2d"
    data_shards: int = 1

    def __post_init__(self):
        if self.mode not in ("2d", "fsdp"):
            raise ValueError(f"ShardPolicy mode must be '2d' or 'fsdp', "
                             f"got {self.mode!r}")
        if int(self.data_shards) < 1:
            raise ValueError(f"ShardPolicy data_shards must be >= 1, "
                             f"got {self.data_shards!r}")

    @property
    def is_fsdp(self) -> bool:
        return self.mode == "fsdp"

    def dp_axes(self, mesh):
        if self.is_fsdp:
            return tuple(a for a in ("pod", "data", "model")
                         if a in mesh.axis_names)
        return tuple(a for a in ("pod", "data") if a in mesh.axis_names)

    def fsdp_axes(self, mesh):
        if self.is_fsdp:
            return tuple(a for a in ("data", "model")
                         if a in mesh.axis_names)
        return tuple(a for a in ("data",) if a in mesh.axis_names)


# the policy used when a caller passes none (immutable: no global setter)
DEFAULT_POLICY = ShardPolicy("2d")


def resolve_policy(policy: Optional[ShardPolicy]) -> ShardPolicy:
    return DEFAULT_POLICY if policy is None else policy


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = dict(mesh.shape)
    return int(math.prod(shape[a] for a in axes))


def dp_axes(mesh, policy: Optional[ShardPolicy] = None):
    return resolve_policy(policy).dp_axes(mesh)


def fsdp_axes(mesh, policy: Optional[ShardPolicy] = None):
    return resolve_policy(policy).fsdp_axes(mesh)


def _strip(spec: list) -> tuple:
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def pick_spec(shape: Sequence[int], mesh,
              candidates: Sequence[Sequence[Any]]) -> tuple:
    """For each dim, the first candidate axis (or axis tuple) that divides
    the dim and whose axes are still unused on this tensor."""
    used: set = set()
    out = []
    for dim, cands in zip(shape, candidates):
        chosen = None
        for cand in cands:
            if cand is None:
                break
            axes = (cand,) if isinstance(cand, str) else tuple(cand)
            if any(a in used or a not in mesh.axis_names for a in axes):
                continue
            size = axis_size(mesh, axes)
            if dim % size == 0 and size > 1:
                chosen = axes if len(axes) > 1 else axes[0]
                used.update(axes)
                break
        out.append(chosen)
    out += [None] * (len(shape) - len(out))
    return _strip(out)


def local_slice(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's part of ``t`` under ``spec`` (a view): each sharded dim
    cut into its axes' size, the rank's block by its mesh coordinates
    (row-major over an axis tuple).  :func:`gather_leaf` inverts it."""
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = 0
        for a in axes:
            idx = idx * int(dict(mesh.shape)[a]) + mesh.index(a)
        size = t.shape[dim] // axis_size(mesh, axes)
        t = t.narrow(dim, idx * size, size)
    return t


def gather_leaf(t: torch.Tensor, spec: tuple, mesh,
                axes=None) -> torch.Tensor:
    """The full tensor from this rank's :func:`local_slice` of it: an
    all-gather along each sharded dim over its axis or axes (every rank
    of the mesh calls it); with ``axes``, only the dims split over axes
    among them (the fsdp axes of a tensor-parallel step), the others
    left as this rank's slice."""
    for dim, a in enumerate(spec):
        if a is not None and (axes is None or _within(a, axes)):
            t = mesh.all_gather(t, a, dim)
    return t


def _within(spec_axes, axes) -> bool:
    """Are all of a dim's spec axes among ``axes``?  (Mixed dims, an
    fsdp tuple with ``"model"``, do not occur in mode ``"2d"``.)"""
    names = (spec_axes,) if isinstance(spec_axes, str) else tuple(spec_axes)
    inside = [a in axes for a in names]
    if any(inside) and not all(inside):
        raise ValueError(f"dim split over {names}: gather all of them or "
                         f"none (axes {tuple(axes)})")
    return all(inside)


def slice_axes(t: torch.Tensor, spec: tuple, mesh, axes) -> torch.Tensor:
    """This rank's block of ``t`` over the dims ``spec`` splits over
    ``axes`` alone (the inverse of :func:`gather_leaf` with ``axes``)."""
    return local_slice(t, tuple(a if a is not None and _within(a, axes)
                                else None for a in spec), mesh)


def shard_tree(tree, specs, mesh):
    """This rank's slices of a tree of full tensors under a spec tree of
    the same structure (:func:`state_specs`, :func:`param_specs`): own
    copies, so the full tensors can go; replicated leaves stay as they
    are."""
    from repro_torch.tree import tree_map

    return tree_map(lambda t, s: local_slice(t, s, mesh).clone()
                    if any(a is not None for a in s) else t, tree, specs)


def unshard_tree(tree, specs, mesh):
    """The full tensors of a tree of this rank's slices (the inverse of
    :func:`shard_tree`), gathered leaf by leaf."""
    from repro_torch.tree import tree_map

    return tree_map(lambda t, s: gather_leaf(t, s, mesh), tree, specs)


def gather_tree(tree, specs, mesh, axes):
    """:func:`unshard_tree` over ``axes`` alone (the fsdp axes of a
    tensor-parallel step): each leaf whole on those axes and this rank's
    slice on the others."""
    from repro_torch.tree import tree_map

    return tree_map(lambda t, s: gather_leaf(t, s, mesh, axes), tree, specs)


def spec_leaves(tree, specs) -> list:
    """The specs of ``tree``'s leaves, in :func:`repro_torch.tree.leaves`
    order (a spec is a tuple, so the spec tree alone does not say where
    its leaves end)."""
    from repro_torch.tree import tree_map

    out: list = []
    tree_map(lambda _t, s: out.append(s), tree, specs)
    return out


def sharded_leaf_reduce(values: list, tree, specs, mesh, op: str) -> list:
    """Per-leaf statistics of a tree of slices (one 0-dim tensor a leaf
    of ``tree``, in leaf order) reduced with ``op`` over the axes that
    shard each leaf under ``specs``, one collective an axis; a statistic
    of a leaf no axis shards stays as it is."""
    if not values:
        return values
    v = torch.stack(values)
    per_leaf = [sharded_axes(s) for s in spec_leaves(tree, specs)]
    for a in ("data", "model"):
        hit = [a in axes for axes in per_leaf]
        if any(hit):
            v = torch.where(torch.tensor(hit, device=v.device),
                            mesh.all_reduce(v, a, op=op), v)
    return list(v.unbind())


def sharded_axes(spec: tuple) -> tuple:
    """The mesh axes ``spec`` splits some dim over, in mesh order."""
    used = {a for axes in spec if axes is not None
            for a in ((axes,) if isinstance(axes, str) else axes)}
    return tuple(a for a in ("data", "model") if a in used)


# ------------------------------------------------------------- parameters

_ROW_PARALLEL_PARENTS = ("down", "wo", "out", "out_proj", "w_ukv")


def splits_on_model(spec: tuple) -> bool:
    """Does ``spec`` put a dim of its leaf on ``"model"``?  In a
    tensor-parallel training step such a leaf is the rank's slice: a
    column-parallel weight's output columns, a row-parallel one's rows
    (``_ROW_PARALLEL_PARENTS``), the embedding's vocabulary block; the
    model code computes with it as that tile (``models.layers``,
    ``models.attention``).  A leaf of no such dim is used whole."""
    return any(a == "model" or (isinstance(a, tuple) and "model" in a)
               for a in spec)


# weight leaves a tensor-parallel step may use whole where the model axis
# does not divide their "model" dim: the model code then computes all of
# them on every rank (the head's every logit), or sums the gradient of
# the part each rank uses over "model" (SSD's in_proj)
WHOLE_LEAVES = ("['embed']['table']", "['lm_head']['w']",
                "['in_proj']['w']")


def tp_config(cfg) -> bool:
    """Does ``cfg`` train tensor-parallel in mode ``"2d"``: a decoder whose
    every block is MHA/GQA attention and a dense MLP, an RG-LRU block
    and a dense MLP, or an SSD mixer (no MLA, MoE or encoder-decoder),
    and whose weights carry no XNOR 1-bit per-tensor scale (a mean over
    the whole weight, which no tile reproduces).  The other configs keep
    the replicated form: every leaf gathered whole on ``"model"`` but
    the experts'."""
    from repro_torch.core.quant import Coding

    if cfg.mla or cfg.moe or cfg.is_encdec \
            or any(k not in ("attn", "rec", "ssm") for k in cfg.pattern()):
        return False
    for kind, tags in (("attn", ("attn.q", "attn.k", "attn.v", "attn.o")),
                       ("mlp", ("mlp.gate", "mlp.up", "mlp.down")),
                       ("ssm", ("ssm.in_proj", "ssm.out_proj")),
                       ("rec", ("rec.in_x", "rec.in_gate", "rec.out")),
                       ("unembed", ("unembed",))):
        sp = cfg.policy.resolver(kind)
        for tag in tags:
            spec = sp(tag)
            if spec is not None and not spec.is_digital \
                    and Coding(spec.coding) == Coding.XNOR \
                    and spec.ba == 1 and not spec.per_channel:
                return False
    return True


def _param_rule(path: str, shape, policy: ShardPolicy) -> list:
    """Candidate lists for the trailing dims; leading (stacked) dims get
    none.  Returns the full candidate list, aligned right."""
    nd = len(shape)
    if policy.is_fsdp:
        zero3 = [("data", "model"), ("model",), ("data",)]
        if nd >= 2:
            trail = [zero3, zero3]
            if nd >= 3 and not path.endswith("['conv_w']"):
                trail = [zero3] * min(nd, 3)
        elif nd == 1:
            trail = [[]]
        else:
            trail = []
        return [[]] * (nd - len(trail)) + trail
    if path.endswith("['table']"):                     # embedding [V, d]
        trail = [["model"], ["data"]]
    elif "['w_gate']" in path or "['w_up']" in path or "['w_down']" in path:
        trail = [["model"], ["data"], []]              # experts [E, in, out]
    elif path.endswith("['w']"):
        parent = path.split("][")[-2] if "][" in path else ""
        if any(k in parent for k in _ROW_PARALLEL_PARENTS):
            trail = [["model"], ["data"]]              # row-parallel
        else:
            trail = [["data"], ["model"]]              # column-parallel
    elif path.endswith("['conv_w']"):
        trail = [[], ["model"]]                        # [k, channels]
    elif path.endswith("['dec_pos']") or path.endswith("['pos']"):
        trail = [[], ["data"]]
    else:
        trail = [[]] * min(nd, 1)                      # 1-D/scalars replicate
    return [[]] * (nd - len(trail)) + trail


def expert_block(shape, mesh, policy: Optional[ShardPolicy] = None) \
        -> tuple:
    """``(axes, first, count)``: the experts a rank computes in a training
    step on ``mesh``, for an expert leaf of ``shape`` ([E, in, out] or
    stacked [..., E, in, out]).  Its E axis's spec under
    :func:`param_specs` (``"model"`` in mode ``"2d"``) names ``axes``,
    and the rank computes its block of the E experts on them, the slice
    the step keeps of the leaf's gradient.  Where that spec does not
    split E (E not divisible, a ``pick_spec`` fallback) or splits it over
    dp axes (mode ``"fsdp"``: every rank holds other rows), ``axes`` is
    empty and the rank computes all E."""
    pol = resolve_policy(policy)
    shape = tuple(shape)
    spec = pick_spec(shape, mesh, _param_rule("['w_gate']", shape, pol))
    e_dim = len(shape) - 3
    cand = spec[e_dim] if len(spec) > e_dim else None
    axes = () if cand is None else \
        ((cand,) if isinstance(cand, str) else tuple(cand))
    e = shape[e_dim]
    if not axes or any(a in pol.dp_axes(mesh) for a in axes):
        return (), 0, e
    count = e // axis_size(mesh, axes)
    idx = 0
    for a in axes:
        idx = idx * int(dict(mesh.shape)[a]) + mesh.index(a)
    return axes, idx * count, count


# ------------------------------------------------- compiled weight images

class ImageSpecs(NamedTuple):
    """The specs of one installed CimaImage's stored leaves."""

    ws: tuple
    wq: tuple
    scale: tuple


def _image_leaf_spec(pstr: str, shape, program, mesh) -> Optional[tuple]:
    """The spec of one leaf of an installed CimaImage, or None for any
    other leaf.  The image's ``partition`` decides: ``"col"`` splits
    ``ws`` [..., N, BA, M], ``wq`` [..., N, M] and a per-channel
    ``scale`` [..., 1, M] on the last dim; ``"row"`` splits ``ws`` on
    dim -3 and ``wq`` on dim -2 (the scale replicates); an unpartitioned
    image, or one compiled for another mesh, replicates."""
    tokens = [a or b for a, b in
              re.findall(r"\['([^']+)'\]|\.([A-Za-z_]\w*)", pstr)]
    if "cima" not in tokens:
        return None
    field = tokens[-1]
    img = program.images.get(".".join(tokens[:-1]))
    if img is None or field not in ("ws", "wq", "scale"):
        return None
    part = img.partition
    if part not in ("col", "row") or img.devices <= 1 \
            or "model" not in mesh.axis_names \
            or dict(mesh.shape)["model"] != img.devices:
        return ()
    nd = len(shape)
    spec: list = [None] * nd
    if part == "col":
        if field == "scale" and not img.per_channel:
            return ()
        spec[nd - 1] = "model"
    elif field == "ws":
        spec[nd - 3] = "model"
    elif field == "wq":
        spec[nd - 2] = "model"
    return tuple(spec)


def _logical_shape(img, field: str) -> tuple:
    """A stored image leaf's logical (whole-image) shape: a tile's
    partitioned dim times the devices."""
    t = getattr(img, field)
    shape = list(t.shape)
    if img.tile is not None and img.partition in ("col", "row"):
        if img.partition == "col" and (field != "scale" or img.per_channel):
            shape[-1] = img.m
        elif img.partition == "row" and field != "scale":
            shape[-3 if field == "ws" else -2] = img.n
    return tuple(shape)


def _map_with_path(fn, tree, prefix: str = ""):
    """``fn(keystr, leaf)`` over a parameter tree, keys named as
    ``jax.tree_util.keystr`` names them; a CimaImage maps to its
    :class:`ImageSpecs`."""
    from repro_torch.accel.program import CimaImage

    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, CimaImage):
        return ImageSpecs(*(fn(f"{prefix}.{f}", _Shape(_logical_shape(
            tree, f))) for f in ImageSpecs._fields))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, f"{prefix}.{name}")
                            for name, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


class _Shape(NamedTuple):
    shape: tuple


def param_specs(params, mesh, policy: Optional[ShardPolicy] = None,
                program=None):
    """Parameter tree -> spec tree (path-based rules).  ``program`` adds
    the rules of its installed images (:func:`_image_leaf_spec`), whose
    leaves map to :class:`ImageSpecs`; without it image leaves fall
    through the weight rules."""
    pol = resolve_policy(policy)

    def one(pstr, leaf):
        if program is not None:
            ispec = _image_leaf_spec(pstr, leaf.shape, program, mesh)
            if ispec is not None:
                return ispec
        return pick_spec(leaf.shape, mesh,
                         _param_rule(pstr, leaf.shape, pol))

    return _map_with_path(one, params)


# ------------------------------------------------------------------ batch

def batch_specs(batch, mesh, batch_size: int,
                policy: Optional[ShardPolicy] = None):
    dp = dp_axes(mesh, policy)

    def one(_pstr, leaf):
        cands = [[dp] if d == batch_size else [] for d in leaf.shape]
        return pick_spec(leaf.shape, mesh, cands)

    return _map_with_path(one, batch)


# ------------------------------------------------------------------ cache

def cache_spec(shape, mesh, batch_size: int,
               policy: Optional[ShardPolicy] = None) -> tuple:
    """One cache leaf's spec: DP on the batch dim (the first dim of size
    ``batch_size``), "model" on the largest divisible other dim."""
    shape = tuple(shape)
    if not shape:
        return ()
    dp = dp_axes(mesh, policy)
    msize = axis_size(mesh, ("model",))
    try:
        bdim = shape.index(batch_size)
    except ValueError:
        bdim = -1
    cand_dims = [i for i, d in enumerate(shape)
                 if i != bdim and d % msize == 0 and d >= msize]
    mdim = max(cand_dims, key=lambda i: shape[i]) if cand_dims else -1
    spec: list = []
    for i, d in enumerate(shape):
        if i == bdim and dp and d % axis_size(mesh, dp) == 0:
            spec.append(dp if len(dp) > 1 else dp[0])
        elif i == mdim:
            spec.append("model")
        else:
            spec.append(None)
    return _strip(spec)


def state_specs(state, mesh, policy: Optional[ShardPolicy] = None):
    """A :class:`~repro_torch.train.state.TrainState` of specs: params, the
    AdamW moments and the compression error tree (None without one) take
    the parameter rules; ``count`` and ``step`` replicate (``()``).
    ``state`` holds full shapes (tensors or anything with ``shape``)."""
    from repro_torch.optim.adamw import OptState
    from repro_torch.train.state import TrainState

    return TrainState(
        params=param_specs(state.params, mesh, policy),
        opt=OptState(mu=param_specs(state.opt.mu, mesh, policy),
                     nu=param_specs(state.opt.nu, mesh, policy), count=()),
        error=(None if state.error is None
               else param_specs(state.error, mesh, policy)),
        step=())


def cache_specs(cache, mesh, batch_size: int,
                policy: Optional[ShardPolicy] = None):
    """Generic cache rule over a cache tree (KV caches, MLA latents,
    LRU/SSM states).  ``batch_size == 1`` (an admission prefill's slot
    cache) is deterministic: the first size-1 dim is the batch dim and is
    kept off the model axis, so a slot cache gets the live cache's
    non-batch layout.

    This is the reference's rule ("model" on the largest divisible
    non-batch dim: the sequence dim of olmo-1b's [16, B, 32768, 16, 128]
    decode_32k leaves).
    The live layout the serving engine holds is another where attention
    runs on the rank's heads or head dims: "model" on the kv-head dim
    (mode "kv") or on the head dim (mode "d"), as the reference's own
    attention constraints put them on "tp" (XLA reshards between the
    two); the SSM state holds the rank's heads (or head dims) and the
    conv state its x channels, the LRU states the rank's width slice,
    and MLA's latent cache stays whole (``models.mixer_split``: the
    reference's constraints on ``xs``, ``xr`` and ``kvu``).  A split over
    the cache's sequence, this rule's layout, waits (ROADMAP 4r)."""
    return _map_with_path(
        lambda _p, leaf: cache_spec(leaf.shape, mesh, batch_size, policy),
        cache)
