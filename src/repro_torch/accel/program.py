"""Weight-stationary CIMA programs: compile-once bit-plane images plus a
capacity-aware bank allocator (paper Fig. 8).  Port of
``repro.accel.program``.

The chip is weight-stationary: matrix elements are written into the CIMA
once and every MVM reuses them.  :func:`build_program` walks a model's
params under its :class:`~repro_torch.accel.policy.PrecisionPolicy`
once, quantizes every managed projection onto its spec's coding grid and
decomposes it into the kernel's ``[N, B_A, M]`` int8 plane layout — a
:class:`CimaImage` per projection.  :func:`install_program` puts each
image next to the weight it was compiled from (key ``"cima"``), so the
per-layer slicing of the stacked ``"scanned"`` leaves slices images
exactly like weights, and dispatch consumes the image instead of
re-quantizing: zero weight ``quantize``/``weight_planes`` ops on the
serving path, bit-for-bit the on-the-fly result.

The **bank allocator** places images onto ``capacity_chips`` physical
CIMAs (2304 rows x 256 columns = 590kb each).  An [N, M] image at B_A
bits occupies ``ceil(N/2304) * ceil(M*B_A/256)`` array tiles per copy
(stacked layers are separate copies; residency is decided per stacked
leaf, all copies together; a MoE layer's experts and whisper's per-layer
cross-attention stack are copies too).
Images are placed first-fit in model order;
what exceeds capacity is *streamed*: reloaded on every forward pass,
double-buffered behind compute unless ``double_buffer=False``, and
charged in :func:`~repro_torch.accel.context.trace` records and
:func:`~repro_torch.accel.context.energy_summary`.  Streaming is
accounting only: the arithmetic is the resident program's.
:class:`ProgramManager` rebuilds a program lazily after the weights move.

``model_shards``/``data_shards`` give the allocator the reference's
``data x model`` mesh arithmetic (:func:`partition_for`): a partitioned
image's tiles and segments are per-device shard sizes and residency is
decided against the per-device budget.  With a ``mesh``
(:class:`~repro_torch.launch.mesh.ServeMesh`) each rank compiles only its
own tile of every partitioned image (``CimaImage.tile``): the planes,
grid and per-column scale of its ``n / devices`` rows (``"row"``) or
``m / devices`` columns (``"col"``), the same bits as slicing the whole
image, and dispatch runs it through :mod:`repro_torch.accel.shard`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Optional

import torch

from repro_torch.core import energy as E
from repro_torch.core.quant import Coding, quantize
from repro_torch.kernels.cima_mvm import int8_planes

# Backends whose weight side is the shared integer grid of core.quant: a
# compiled image is valid for ANY of them, which is what lets
# override(backend=...) flip substrates without recompiling.
PROGRAM_BACKENDS = ("digital_int", "bpbs", "bpbs_ref", "kernel")


@dataclasses.dataclass
class CimaImage:
    """One projection compiled for the CIMA: int8 bit planes + scales.

    ``ws`` is the kernel layout ``[..., N, B_A, M]`` (leading axes are
    stacked copies: scanned layers, experts); ``wq`` is the same matrix on the
    integer grid (int16, what ``digital_int`` consumes); ``scale`` is the
    weight quantization scale (``[..., 1, M]`` per channel, ``[...]`` per
    tensor)."""

    ws: torch.Tensor
    wq: torch.Tensor
    scale: torch.Tensor
    path: str = ""                # param-tree location (unique program key)
    tag: str = ""                 # policy path the spec resolved
    ba: int = 4
    coding: Coding = Coding.XNOR
    per_channel: bool = True
    n: int = 0                    # per-copy rows
    m: int = 0                    # per-copy output columns
    copies: int = 1               # stacked instances (layers x experts)
    tiles: int = 0                # 2304x256 array tiles per copy
    segments: int = 0             # 768-b row segments per copy
    resident: bool = True         # placed in the standing allocation?
    # double-buffered streaming: a streamed image's reload prefetches
    # into the spare bank set while the other set computes (accounting
    # only; dispatch stamps it on MvmRecord.stream_overlap)
    overlap: bool = False
    # mesh mapping (accounting): "col"/"row" split over ``devices``
    # model-axis shards, and the data-axis replicas
    partition: Optional[str] = None
    devices: int = 1
    data_shards: int = 1
    # the model-axis index of the tile the arrays hold (None: the whole
    # image); ``n``/``m`` stay the logical sizes
    tile: Optional[int] = None

    def layer(self, i: int) -> "CimaImage":
        """The image of index ``i`` on the leading stacked axis (one
        scanned layer, or one expert of a layer), with the stack's
        placement, so each dispatch charges its own copies' reloads."""
        return dataclasses.replace(self, ws=self.ws[i], wq=self.wq[i],
                                   scale=self.scale[i],
                                   copies=self.copies // self.ws.shape[0])


def image_tiles(n: int, m: int, ba: int) -> int:
    """Array tiles (full 2304x256 CIMAs) one [N, M] image copy occupies."""
    return math.ceil(n / E.CIMA_ROWS) * math.ceil(m * ba / E.CIMA_COLS)


def image_segments(n: int, m: int, ba: int) -> int:
    """768-b row segments written to load one [N, M] image copy: per
    column tile ``ceil(N * 256 / 768)``, for a full array the 768
    segments behind the paper's ~18k-cycle reload."""
    col_tiles = math.ceil(m * ba / E.CIMA_COLS)
    return col_tiles * math.ceil(n * E.CIMA_COLS / E.A_ROW_SEGMENT)


def segment_cycles() -> int:
    """Cycles per 768-b row segment: DMA-bound at max(C_A, C_LOAD)."""
    return max(E.C_A, E.C_LOAD)


def segment_dma_words() -> int:
    """32-b DMA words delivered per 768-b row segment."""
    return E.A_ROW_SEGMENT // E.DMA_WORD


# tag leaves whose projection is the second GEMM of a Megatron pair (the
# input is already split over the model axis): split along N, partial
# sums all-reduced after the ADC epilogue.  Derived from the parameter
# names the reference's sharding rules mark row-parallel
# (``repro.distributed.sharding._ROW_PARALLEL_PARENTS``) through the
# name -> policy-tag-leaf map, but for MLA's ``w_ukv``, which a serving
# program cuts into column tiles: the reference's activation constraint
# on its output (``kvu`` on its heads over "tp", the latent whole; repro/
# models/attention.py:440-441) is what a column tile of its h * (dn + dv)
# columns gives each rank with no collective, its own heads' keys and
# values, where a row tile would all-reduce the whole expansion (4.29 GB
# a layer at decode_32k).  A column tile holds the unsharded image's
# bits: the whole N and the global input scale stay on every rank.  The
# parameter rule of training (``distributed/sharding.py``) keeps the
# reference's row split.
_ROW_PARALLEL_PARENTS = ("down", "wo", "out", "out_proj")
_PARENT_TO_TAG_LEAF = {"down": "down", "wo": "o", "out": "out",
                       "out_proj": "out_proj"}
_ROW_PARALLEL_LEAVES = tuple(_PARENT_TO_TAG_LEAF[p]
                             for p in _ROW_PARALLEL_PARENTS)


def sharding_excluded(tag: str) -> bool:
    """Is this projection a grouped call (MoE expert stacks, whisper's
    per-layer cross-attention), whose group axis is the natural shard and
    which is therefore never partitioned over the "model" axis?"""
    return tag in _MOE_EXPERT.values() or tag.startswith("cross.")


def partition_for(tag: str, n: int, m: int, shards: int) -> Optional[str]:
    """How one projection splits across ``shards`` model-axis devices:
    ``"col"`` (planes split along M, no collective) by default, ``"row"``
    (split along N, all-reduce after the ADC epilogue) for the second
    GEMM of each Megatron pair; the other axis when the preferred one
    does not divide, ``None`` (replicated) when neither does or the
    projection is :func:`sharding_excluded`."""
    if shards <= 1:
        return None
    if sharding_excluded(tag):
        return None
    leaf = tag.rsplit(".", 1)[-1]
    if leaf in _ROW_PARALLEL_LEAVES:
        if n % shards == 0:
            return "row"
        return "col" if m % shards == 0 else None
    if m % shards == 0:
        return "col"
    return "row" if n % shards == 0 else None


def tile_bounds(size: int, devices: int, tile: int) -> tuple:
    """``(start, stop)`` of tile ``tile`` of ``size`` split ``devices``
    ways."""
    step = size // devices
    return tile * step, (tile + 1) * step


def _compile_image(w: torch.Tensor, spec, path: str, shards: int = 1,
                   partition: Optional[str] = None,
                   tile: Optional[int] = None) -> CimaImage:
    """Quantize + decompose one (possibly stacked) projection exactly as
    the on-the-fly backends do per call, one copy at a time, each written
    into its slot of the preallocated stacked image (a MoE stack of
    7 x 64 experts would hold its planes twice over if they were stacked
    from a list).  ``partition``/``shards`` set the accounting (tiles and
    segments of one device's shard) and the metadata; ``tile`` keeps
    only that model-axis tile of a partitioned image: each copy is
    quantized whole (a per-tensor scale sees every element) and its
    tile's rows or columns decomposed."""
    lead = tuple(w.shape[:-2])
    n, m = int(w.shape[-2]), int(w.shape[-1])
    cfg = spec.bpbs()
    flat = w.reshape((-1, n, m))
    copies = flat.shape[0]
    devices = shards if partition in ("col", "row") else 1
    n_loc = n // devices if partition == "row" else n
    m_loc = m // devices if partition == "col" else m
    if devices == 1:
        tile = None
    rows, cols = slice(0, n), slice(0, m)
    if tile is not None:
        if partition == "row":
            rows = slice(*tile_bounds(n, devices, tile))
        else:
            cols = slice(*tile_bounds(m, devices, tile))
    ws = torch.empty((copies, rows.stop - rows.start, cfg.ba,
                      cols.stop - cols.start), dtype=torch.int8,
                     device=w.device)
    wq = torch.empty(ws.shape[:2] + ws.shape[3:], dtype=torch.int16,
                     device=w.device)
    scales = []
    for i, wi in enumerate(flat):
        qw = quantize(wi.to(torch.float32), spec.ba, spec.coding,
                      axis=1 if spec.per_channel else None)
        q = qw.q[rows, cols]
        ws[i] = int8_planes(q, cfg)
        wq[i] = q
        scale = qw.scale
        if spec.per_channel and partition == "col":
            scale = scale[..., cols]
        scales.append(scale)
    scale = torch.stack(scales)
    ws = ws.reshape(lead + ws.shape[1:])
    wq = wq.reshape(lead + wq.shape[1:])
    scale = scale.reshape(lead + scale.shape[1:])
    return CimaImage(ws=ws, wq=wq, scale=scale, path=path,
                     tag=spec.tag, ba=spec.ba, coding=Coding(spec.coding),
                     per_channel=spec.per_channel, n=n, m=m,
                     copies=int(math.prod(lead)) if lead else 1,
                     tiles=image_tiles(n_loc, m_loc, spec.ba),
                     segments=image_segments(n_loc, m_loc, spec.ba),
                     partition=partition if devices > 1 else None,
                     devices=devices, tile=tile)


def stored_shape(img: CimaImage, w_shape) -> tuple:
    """The ``ws`` shape ``img`` stores for a weight of ``w_shape``: a
    tile's partitioned dim is the logical one over the devices."""
    n, m = int(w_shape[-2]), int(w_shape[-1])
    if img.tile is not None:
        if img.partition == "row":
            n //= img.devices
        else:
            m //= img.devices
    return tuple(w_shape[:-2]) + (n, img.ba, m)


def image_matches(img: Optional[CimaImage], spec, w: torch.Tensor) -> bool:
    """Is ``img`` a valid compiled form of ``w`` under ``spec``?  Validity
    depends only on the grid fields (B_A, coding, per_channel) and the
    shape: an ``override(backend=...)`` keeps the image, an
    ``override(ba=...)`` drops to the on-the-fly path."""
    return (
        img is not None
        and spec.backend in PROGRAM_BACKENDS
        and img.ba == spec.ba
        and Coding(img.coding) == Coding(spec.coding)
        and img.per_channel == spec.per_channel
        and tuple(img.ws.shape) == stored_shape(img, w.shape)
    )


# ------------------------------------------------------ param-tree walk

# attention param names -> policy path suffixes (see models.attention)
_ATTN = {"wq": "q", "wk": "k", "wv": "v", "wo": "o",
         "w_dkv": "dkv", "w_krope": "krope", "w_ukv": "ukv"}
# raw stacked expert arrays in the moe dict -> policy paths
_MOE_EXPERT = {"w_gate": "moe.gate", "w_up": "moe.up", "w_down": "moe.down"}


def _classify(names: tuple) -> Optional[tuple]:
    """(policy_path, kind) of the linear dict at key chain ``names``, or
    None for unmanaged / by-design-digital projections (the MoE router and
    the RG-LRU gates ``w_rg``/``w_ig`` dispatch with ``spec=None`` and
    never quantize)."""
    leaf = names[-1]
    if leaf == "lm_head":
        return "unembed", "unembed"
    if "attn" in names:
        if leaf in _ATTN:
            # whisper's per-layer cross-attention takes the cross.* paths
            prefix = "cross" if "cross" in names else "attn"
            return f"{prefix}.{_ATTN[leaf]}", "attn"
        return None
    if "rec" in names:
        return (f"rec.{leaf}", "rec") if leaf in ("in_x", "in_gate", "out") \
            else None
    if "ssm" in names:
        return (f"ssm.{leaf}", "ssm") if leaf in ("in_proj", "out_proj") \
            else None
    if "moe" in names:
        if "shared" in names and leaf in ("gate", "up", "down"):
            return f"moe.shared.{leaf}", "moe"
        return None                       # router: digital by design
    if "mlp" in names and leaf in ("gate", "up", "down"):
        return f"mlp.{leaf}", "mlp"
    return None


def _walk(params: Any, cfg) -> Iterator[tuple]:
    """Yield ``(container_path, install_key, tag, kind, w)`` per managed
    projection, in model order; the image installs at ``container_path``
    under ``install_key``: ``"cima"`` beside a linear's ``"w"``, or
    ``("cima", "gate")`` (``up``, ``down``) for the raw stacked expert
    arrays ``w_gate``/``w_up``/``w_down`` [..., E, N, M] of a moe dict."""

    def visit(node, path):
        if isinstance(node, dict):
            if "w" in node and isinstance(node["w"], torch.Tensor) \
                    and node["w"].ndim >= 2:
                names = tuple(k for k in path if isinstance(k, str))
                hit = _classify(names) if names else None
                if hit is not None:
                    yield path, "cima", hit[0], hit[1], node["w"]
                return                      # a linear dict is a leaf module
            for k, v in node.items():
                if k in _MOE_EXPERT and "moe" in path \
                        and isinstance(v, torch.Tensor) and v.ndim >= 2:
                    yield (path, ("cima", _MOE_EXPERT[k].split(".")[1]),
                           _MOE_EXPERT[k], "moe", v)
                else:
                    yield from visit(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                yield from visit(v, path + (i,))

    yield from visit(params, ())
    # tied unembed: the managed MVM is x @ table.T — compile the transpose
    if cfg.tie_embeddings and isinstance(params, dict) \
            and "table" in params.get("embed", {}):
        yield (("embed",), "cima", "unembed", "unembed",
               params["embed"]["table"].T)


def _path_str(path: tuple, key) -> str:
    return ".".join([str(p) for p in path]
                    + (list(key) if isinstance(key, tuple) else [key]))


# ----------------------------------------------------- footprints & plans

@dataclasses.dataclass(frozen=True)
class ImageFootprint:
    """The policy-independent shape of one managed projection: what the
    bank allocator needs to place its image."""

    path: str         # param-tree install path (unique program key)
    tag: str          # policy path the projection resolves under
    kind: str         # policy kind ("attn", "mlp", ...)
    n: int            # per-copy contraction rows
    m: int            # per-copy output columns
    copies: int = 1   # stacked instances (layers x experts)


@dataclasses.dataclass(frozen=True)
class Placement:
    """One allocator decision: where a footprint lands under a policy
    (``spec`` is the resolved ExecSpec; its ``ba`` sets the tiles)."""

    footprint: ImageFootprint
    spec: object
    partition: Optional[str] = None
    devices: int = 1
    tiles: int = 0
    segments: int = 0
    resident: bool = True
    overlap: bool = False
    data_shards: int = 1


def model_footprint(params, cfg) -> list:
    """Every policy-managed projection of ``params`` as an
    :class:`ImageFootprint`, in model (= allocation) order; reads shapes
    only."""
    out = []
    for path, key, tag, kind, w in _walk(params, cfg):
        lead = tuple(w.shape[:-2])
        out.append(ImageFootprint(
            path=_path_str(path, key), tag=tag, kind=kind,
            n=int(w.shape[-2]), m=int(w.shape[-1]),
            copies=int(math.prod(lead)) if lead else 1))
    return out


def plan_allocation(footprints, policy, capacity_chips: Optional[int] = None,
                    model_shards: int = 1, data_shards: int = 1,
                    double_buffer: bool = True) -> dict:
    """First-fit bank allocation of ``footprints`` under ``policy``:
    ``{path: Placement}`` for every projection the policy routes to a
    program backend.  Each projection is partitioned over
    ``model_shards`` devices per :func:`partition_for` and placed against
    the PER-DEVICE ``capacity_chips`` budget; a footprint whose copies
    together exceed what is left of it streams (``overlap`` per
    ``double_buffer``); later, smaller ones may still fit.  The data axis
    never cuts an image: it is stamped on every placement.  This is the
    one allocator: :func:`build_program` compiles to this plan and the
    tuner re-runs it per design point."""
    plan: dict = {}
    used = 0
    for fp in footprints:
        spec = policy.resolve(fp.tag, kind=fp.kind)
        if spec.backend not in PROGRAM_BACKENDS:
            continue
        part = partition_for(fp.tag, fp.n, fp.m, model_shards)
        devices = model_shards if part in ("col", "row") else 1
        n_loc = fp.n // devices if part == "row" else fp.n
        m_loc = fp.m // devices if part == "col" else fp.m
        tiles = image_tiles(n_loc, m_loc, spec.ba)
        segments = image_segments(n_loc, m_loc, spec.ba)
        need = tiles * fp.copies
        resident = not (capacity_chips is not None
                        and used + need > capacity_chips)
        if resident:
            used += need
        plan[fp.path] = Placement(
            footprint=fp, spec=spec,
            partition=part if devices > 1 else None, devices=devices,
            tiles=tiles, segments=segments, resident=resident,
            overlap=(not resident) and bool(double_buffer),
            data_shards=max(int(data_shards), 1))
    return plan


# -------------------------------------------------------------- programs

@dataclasses.dataclass
class CimaProgram:
    """A compiled weight-stationary program: images keyed by install path
    plus their allocation.  ``version`` tracks the weight snapshot the
    images were built from (see :class:`ProgramManager`)."""

    images: dict
    capacity_tiles: Optional[int] = None    # None = unbounded (per device)
    version: int = 0
    model_shards: int = 1                   # "model"-axis size at build
    data_shards: int = 1                    # "data"-axis size at build
    double_buffer: bool = True
    # grouped-call tags never partitioned over the model axis
    # (sharding_excluded): their tiles do not shrink with model_shards
    excluded: tuple = ()

    def __bool__(self) -> bool:
        return bool(self.images)

    @property
    def tiles_used(self) -> int:
        return sum(i.tiles * i.copies for i in self.images.values()
                   if i.resident)

    @property
    def tiles_total(self) -> int:
        return sum(i.tiles * i.copies for i in self.images.values())

    def reload_segments_per_pass(self) -> int:
        """Row segments rewritten per forward pass (streamed images)."""
        return sum(i.segments * i.copies for i in self.images.values()
                   if not i.resident)

    def reload_cycles_per_pass(self) -> int:
        return self.reload_segments_per_pass() * segment_cycles()

    def initial_load_cycles(self) -> int:
        """One-time cycles to write the standing (resident) allocation."""
        return sum(i.segments * i.copies for i in self.images.values()
                   if i.resident) * segment_cycles()

    def stream_schedule(self) -> list:
        """One row per streamed image: copies reloaded per pass, segments
        per copy, the full per-pass DMA cycles and whether the reload is
        double-buffered (the hidden/exposed split depends on the trace
        and is :func:`~repro_torch.accel.context.energy_summary`'s)."""
        rows = []
        for img in self.images.values():
            if img.resident:
                continue
            rows.append({
                "tag": img.tag or img.path,
                "path": img.path,
                "copies": img.copies,
                "segments": img.segments,
                "reload_cycles_per_pass":
                    img.segments * img.copies * segment_cycles(),
                "overlap": img.overlap,
            })
        return sorted(rows, key=lambda r: (r["tag"], r["path"]))

    def summary(self) -> dict:
        return {
            "images": len(self.images),
            "copies": sum(i.copies for i in self.images.values()),
            "model_shards": self.model_shards,
            "data_shards": self.data_shards,
            "double_buffer": self.double_buffer,
            "partitioned": sum(1 for i in self.images.values()
                               if i.partition is not None),
            "excluded_from_sharding": sorted(self.excluded),
            "excluded_count": len(self.excluded),
            "capacity_tiles": self.capacity_tiles,
            "capacity_bits": (None if self.capacity_tiles is None else
                              self.capacity_tiles * E.CIMA_ROWS * E.CIMA_COLS),
            "tiles_total": self.tiles_total,
            "tiles_resident": self.tiles_used,
            "streamed": sorted(i.tag or i.path
                               for i in self.images.values()
                               if not i.resident),
            "streamed_images": self.stream_schedule(),
            "initial_load_cycles": self.initial_load_cycles(),
            "reload_cycles_per_pass": self.reload_cycles_per_pass(),
        }


def build_program(params, cfg, capacity_chips: Optional[int] = None,
                  version: int = 0, mesh=None,
                  model_shards: Optional[int] = None,
                  data_shards: Optional[int] = None,
                  double_buffer: bool = True) -> CimaProgram:
    """Compile every policy-managed projection routed to a program backend
    into a :class:`CimaImage` (digital projections are never compiled),
    placed by :func:`plan_allocation` on ``capacity_chips`` 590kb arrays
    per device (None = all resident), partitioned over the ``"model"``
    axis and replicated over ``"data"``.  With ``mesh`` the axis sizes
    are the mesh's and this rank keeps only its tile of each partitioned
    image; explicit ``model_shards``/``data_shards`` without a mesh set
    the accounting and metadata only (whole images).  Streamed images
    are reloaded every pass, double-buffered unless
    ``double_buffer=False``: accounting only, the numerics are the
    resident program's."""
    shape = dict(mesh.shape) if mesh is not None else {}
    shards = int(model_shards if model_shards is not None
                 else shape.get("model", 1))
    data = int(data_shards if data_shards is not None
               else shape.get("data", 1))
    tile = mesh.index("model") if mesh is not None else None
    plan = plan_allocation(model_footprint(params, cfg), cfg.policy,
                           capacity_chips=capacity_chips,
                           model_shards=shards, data_shards=data,
                           double_buffer=double_buffer)
    images: dict = {}
    excluded: list = []
    for path, key, tag, _kind, w in _walk(params, cfg):
        pl = plan.get(_path_str(path, key))
        if pl is None:
            continue
        if shards > 1 and sharding_excluded(tag):
            excluded.append(tag)
        img = _compile_image(w, pl.spec, _path_str(path, key),
                             shards=shards, partition=pl.partition,
                             tile=tile)
        if data > 1:
            img = dataclasses.replace(img, data_shards=data)
        if not pl.resident:
            img = dataclasses.replace(img, resident=False,
                                      overlap=pl.overlap)
        images[img.path] = img
    return CimaProgram(images=images, capacity_tiles=capacity_chips,
                       version=version, model_shards=shards,
                       data_shards=data, double_buffer=bool(double_buffer),
                       excluded=tuple(sorted(set(excluded))))


def _set_in(tree, path: tuple, key, value):
    """Copy of ``tree`` with ``value`` at ``tree[path...][key]`` (a key
    tuple nests: ``("cima", "gate")`` fills ``tree[path...]["cima"]
    ["gate"]``); the containers on the path are copied, the tensors
    shared."""
    if not path:
        keys = key if isinstance(key, tuple) else (key,)
        out = dict(tree)
        out[keys[0]] = (value if len(keys) == 1 else
                        _set_in(tree.get(keys[0], {}), (), keys[1:], value))
        return out
    head, rest = path[0], path[1:]
    out = dict(tree) if isinstance(tree, dict) else list(tree)
    out[head] = _set_in(tree[head], rest, key, value)
    return out if isinstance(tree, dict) else type(tree)(out)


def install_program(params, program: CimaProgram, cfg):
    """A copy of ``params`` with each image inserted next to its weight
    (key ``"cima"``).  Don't train on installed params: the images go
    stale on the first optimizer step."""
    out = params
    for path, key, _tag, _kind, _w in _walk(params, cfg):
        img = program.images.get(_path_str(path, key))
        if img is not None:
            out = _set_in(out, path, key, img)
    return out


def _image_container(v) -> bool:
    """A moe dict's ``"cima"`` entry: a dict of expert images only."""
    return isinstance(v, dict) and bool(v) and all(
        isinstance(x, CimaImage) for x in v.values())


def strip_program(params):
    """Remove every installed image (the inverse of install_program),
    the MoE expert images' container dict with them: an empty
    ``moe["cima"]`` would send ``moe_ffn`` down its image branch."""
    if isinstance(params, dict):
        return {k: strip_program(v) for k, v in params.items()
                if not isinstance(v, CimaImage) and not _image_container(v)}
    if isinstance(params, (list, tuple)):
        return type(params)(strip_program(v) for v in params)
    return params


# ---------------------------------------------------------- invalidation

class ProgramManager:
    """Freshness contract between weight updates and serving/eval: call
    :meth:`invalidate` after the weights move; :meth:`ensure` returns the
    cached program unless it was invalidated (rebuilt lazily, once per
    weight snapshot)."""

    def __init__(self, cfg, capacity_chips: Optional[int] = None,
                 mesh=None, model_shards: Optional[int] = None,
                 data_shards: Optional[int] = None,
                 double_buffer: bool = True):
        self.cfg = cfg
        self.capacity_chips = capacity_chips
        self.mesh = mesh
        self.model_shards = model_shards
        self.data_shards = data_shards
        self.double_buffer = double_buffer
        self._program: Optional[CimaProgram] = None
        self._dirty = True
        self.version = 0
        self.invalidations = 0

    def invalidate(self) -> None:
        """Weights changed: the compiled images are stale."""
        self._dirty = True
        self.invalidations += 1

    def ensure(self, params) -> CimaProgram:
        """The current program for ``params`` (rebuilt only if stale)."""
        if self._dirty or self._program is None:
            self.version += 1
            self._program = build_program(
                params, self.cfg, capacity_chips=self.capacity_chips,
                version=self.version, mesh=self.mesh,
                model_shards=self.model_shards,
                data_shards=self.data_shards,
                double_buffer=self.double_buffer)
            self._dirty = False
        return self._program
