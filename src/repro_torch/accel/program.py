"""Weight-stationary CIMA programs: compile-once bit-plane images plus a
capacity-aware bank allocator (paper Fig. 8).  Port of
``repro.accel.program`` for one device (the mesh arguments wait for the
port's multi-device slice).

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
leaf, all copies together).  Images are placed first-fit in model order;
what exceeds capacity is *streamed*: reloaded on every forward pass,
double-buffered behind compute unless ``double_buffer=False``, and
charged in :func:`~repro_torch.accel.context.trace` records and
:func:`~repro_torch.accel.context.energy_summary`.  Streaming is
accounting only: the arithmetic is the resident program's.
:class:`ProgramManager` rebuilds a program lazily after the weights move.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Optional

import torch

from repro_torch.core import energy as E
from repro_torch.core.bpbs import weight_planes
from repro_torch.core.quant import Coding, quantize

# Backends whose weight side is the shared integer grid of core.quant: a
# compiled image is valid for ANY of them, which is what lets
# override(backend=...) flip substrates without recompiling.
PROGRAM_BACKENDS = ("digital_int", "bpbs", "bpbs_ref", "kernel")


@dataclasses.dataclass
class CimaImage:
    """One projection compiled for the CIMA: int8 bit planes + scales.

    ``ws`` is the kernel layout ``[..., N, B_A, M]`` (leading axes are
    stacked copies: scanned layers); ``wq`` is the same matrix on the
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
    copies: int = 1               # stacked instances (layers)
    tiles: int = 0                # 2304x256 array tiles per copy
    segments: int = 0             # 768-b row segments per copy
    resident: bool = True         # placed in the standing allocation?
    # double-buffered streaming: a streamed image's reload prefetches
    # into the spare bank set while the other set computes (accounting
    # only; dispatch stamps it on MvmRecord.stream_overlap)
    overlap: bool = False
    # mesh mapping, one device until the port's multi-device slice
    partition: Optional[str] = None
    devices: int = 1
    data_shards: int = 1

    def layer(self, i: int) -> "CimaImage":
        """The image of stacked copy ``i`` (one scanned layer): one copy,
        with the stack's placement, so each layer's dispatch charges its
        own copy's reload."""
        return dataclasses.replace(self, ws=self.ws[i], wq=self.wq[i],
                                   scale=self.scale[i], copies=1)


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


def _compile_image(w: torch.Tensor, spec, path: str) -> CimaImage:
    """Quantize + decompose one (possibly stacked) projection exactly as
    the on-the-fly backends do per call, one copy at a time."""
    lead = tuple(w.shape[:-2])
    n, m = int(w.shape[-2]), int(w.shape[-1])
    cfg = spec.bpbs()
    flat = w.reshape((-1, n, m))
    ws, wq, scale = [], [], []
    for wi in flat:
        qw = quantize(wi.to(torch.float32), spec.ba, spec.coding,
                      axis=1 if spec.per_channel else None)
        ws.append(weight_planes(qw.q, cfg).permute(0, 2, 1).to(torch.int8))
        wq.append(qw.q.to(torch.int16))
        scale.append(qw.scale)
    ws, wq, scale = torch.stack(ws), torch.stack(wq), torch.stack(scale)
    if not lead:
        ws, wq, scale = ws[0], wq[0], scale[0]
    else:
        ws = ws.reshape(lead + ws.shape[1:])
        wq = wq.reshape(lead + wq.shape[1:])
        scale = scale.reshape(lead + scale.shape[1:])
    return CimaImage(ws=ws.contiguous(), wq=wq, scale=scale, path=path,
                     tag=spec.tag, ba=spec.ba, coding=Coding(spec.coding),
                     per_channel=spec.per_channel, n=n, m=m,
                     copies=int(math.prod(lead)) if lead else 1,
                     tiles=image_tiles(n, m, spec.ba),
                     segments=image_segments(n, m, spec.ba))


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
        and img.ws.ndim == 3
        and tuple(img.ws.shape) == (w.shape[0], spec.ba, w.shape[1])
    )


# ------------------------------------------------------ param-tree walk

# attention param names -> policy path suffixes (see models.attention)
_ATTN = {"wq": "q", "wk": "k", "wv": "v", "wo": "o"}


def _classify(names: tuple) -> Optional[tuple]:
    """(policy_path, kind) of the linear dict at key chain ``names``, or
    None for unmanaged projections."""
    leaf = names[-1]
    if leaf == "lm_head":
        return "unembed", "unembed"
    if "attn" in names:
        return (f"attn.{_ATTN[leaf]}", "attn") if leaf in _ATTN else None
    if "mlp" in names and leaf in ("gate", "up", "down"):
        return f"mlp.{leaf}", "mlp"
    return None


def _walk(params: Any, cfg) -> Iterator[tuple]:
    """Yield ``(container_path, tag, kind, w)`` per managed projection,
    in model order; the image installs at ``container_path + ("cima",)``."""

    def visit(node, path):
        if isinstance(node, dict):
            if "w" in node and isinstance(node["w"], torch.Tensor) \
                    and node["w"].ndim >= 2:
                names = tuple(k for k in path if isinstance(k, str))
                hit = _classify(names) if names else None
                if hit is not None:
                    yield path, hit[0], hit[1], node["w"]
                return                      # a linear dict is a leaf module
            for k, v in node.items():
                yield from visit(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                yield from visit(v, path + (i,))

    yield from visit(params, ())
    # tied unembed: the managed MVM is x @ table.T — compile the transpose
    if cfg.tie_embeddings and isinstance(params, dict) \
            and "table" in params.get("embed", {}):
        yield ("embed",), "unembed", "unembed", params["embed"]["table"].T


def _path_str(path: tuple) -> str:
    return ".".join([str(p) for p in path] + ["cima"])


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
    copies: int = 1   # stacked instances (layers)


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
    for path, tag, kind, w in _walk(params, cfg):
        lead = tuple(w.shape[:-2])
        out.append(ImageFootprint(
            path=_path_str(path), tag=tag, kind=kind,
            n=int(w.shape[-2]), m=int(w.shape[-1]),
            copies=int(math.prod(lead)) if lead else 1))
    return out


def _one_device(model_shards: int, data_shards: int) -> None:
    if model_shards != 1 or data_shards != 1:
        raise NotImplementedError(
            "the port places programs on one device; model_shards and "
            "data_shards above 1 wait for its multi-device slice")


def plan_allocation(footprints, policy, capacity_chips: Optional[int] = None,
                    model_shards: int = 1, data_shards: int = 1,
                    double_buffer: bool = True) -> dict:
    """First-fit bank allocation of ``footprints`` under ``policy``:
    ``{path: Placement}`` for every projection the policy routes to a
    program backend.  A footprint whose copies together exceed what is
    left of ``capacity_chips`` streams (``overlap`` per
    ``double_buffer``); later, smaller ones may still fit."""
    _one_device(model_shards, data_shards)
    plan: dict = {}
    used = 0
    for fp in footprints:
        spec = policy.resolve(fp.tag, kind=fp.kind)
        if spec.backend not in PROGRAM_BACKENDS:
            continue
        tiles = image_tiles(fp.n, fp.m, spec.ba)
        segments = image_segments(fp.n, fp.m, spec.ba)
        need = tiles * fp.copies
        resident = not (capacity_chips is not None
                        and used + need > capacity_chips)
        if resident:
            used += need
        plan[fp.path] = Placement(
            footprint=fp, spec=spec, tiles=tiles, segments=segments,
            resident=resident, overlap=(not resident) and bool(double_buffer))
    return plan


# -------------------------------------------------------------- programs

@dataclasses.dataclass
class CimaProgram:
    """A compiled weight-stationary program: images keyed by install path
    plus their allocation.  ``version`` tracks the weight snapshot the
    images were built from (see :class:`ProgramManager`)."""

    images: dict
    capacity_tiles: Optional[int] = None    # None = unbounded array
    version: int = 0
    double_buffer: bool = True

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
        """The reference's summary; on one device nothing is partitioned
        or excluded from partitioning."""
        return {
            "images": len(self.images),
            "copies": sum(i.copies for i in self.images.values()),
            "model_shards": 1,
            "data_shards": 1,
            "double_buffer": self.double_buffer,
            "partitioned": 0,
            "excluded_from_sharding": [],
            "excluded_count": 0,
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
                  version: int = 0, double_buffer: bool = True
                  ) -> CimaProgram:
    """Compile every policy-managed projection routed to a program backend
    into a :class:`CimaImage` (digital projections are never compiled),
    placed by :func:`plan_allocation` on ``capacity_chips`` 590kb arrays
    (None = all resident).  Streamed images are reloaded every pass,
    double-buffered unless ``double_buffer=False``: accounting only, the
    numerics are the resident program's."""
    plan = plan_allocation(model_footprint(params, cfg), cfg.policy,
                           capacity_chips=capacity_chips,
                           double_buffer=double_buffer)
    images: dict = {}
    for path, _tag, _kind, w in _walk(params, cfg):
        pl = plan.get(_path_str(path))
        if pl is None:
            continue
        img = _compile_image(w, pl.spec, _path_str(path))
        if not pl.resident:
            img = dataclasses.replace(img, resident=False,
                                      overlap=pl.overlap)
        images[img.path] = img
    return CimaProgram(images=images, capacity_tiles=capacity_chips,
                       version=version, double_buffer=bool(double_buffer))


def _set_in(tree, path: tuple, value):
    """Copy of ``tree`` with ``value`` at ``tree[path...]["cima"]``; the
    containers on the path are copied, the tensors shared."""
    if not path:
        out = dict(tree)
        out["cima"] = value
        return out
    head, rest = path[0], path[1:]
    out = dict(tree) if isinstance(tree, dict) else list(tree)
    out[head] = _set_in(tree[head], rest, value)
    return out if isinstance(tree, dict) else type(tree)(out)


def install_program(params, program: CimaProgram, cfg):
    """A copy of ``params`` with each image inserted next to its weight
    (key ``"cima"``).  Don't train on installed params: the images go
    stale on the first optimizer step."""
    out = params
    for path, _tag, _kind, _w in _walk(params, cfg):
        img = program.images.get(_path_str(path))
        if img is not None:
            out = _set_in(out, path, img)
    return out


def strip_program(params):
    """Remove every installed image (the inverse of install_program)."""
    if isinstance(params, dict):
        return {k: strip_program(v) for k, v in params.items()
                if not isinstance(v, CimaImage)}
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
                 double_buffer: bool = True):
        self.cfg = cfg
        self.capacity_chips = capacity_chips
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
                version=self.version, double_buffer=self.double_buffer)
            self._dirty = False
        return self._program
