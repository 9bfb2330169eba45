"""Weight-stationary CIMA programs: compile-once bit-plane images.
Port of ``repro.accel.program`` for one device, every image resident.

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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Optional

import torch

from repro_torch.core.bpbs import weight_planes
from repro_torch.core.quant import Coding, quantize

# Backends whose weight side is the shared integer grid of core.quant: a
# compiled image is valid for ANY of them, which is what lets
# override(backend=...) flip substrates without recompiling.
PROGRAM_BACKENDS = ("digital_int", "bpbs", "kernel")


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

    def layer(self, i: int) -> "CimaImage":
        """The image of stacked copy ``i`` (one scanned layer)."""
        return dataclasses.replace(self, ws=self.ws[i], wq=self.wq[i],
                                   scale=self.scale[i], copies=1)


@dataclasses.dataclass
class CimaProgram:
    """A compiled weight-stationary program, keyed by install path."""

    images: dict

    def __bool__(self) -> bool:
        return bool(self.images)


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
                     copies=int(math.prod(lead)) if lead else 1)


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


def build_program(params, cfg) -> CimaProgram:
    """Compile every policy-managed projection routed to a program backend
    into a :class:`CimaImage` (digital projections are never compiled)."""
    images: dict = {}
    for path, tag, kind, w in _walk(params, cfg):
        spec = cfg.policy.resolve(tag, kind=kind)
        if spec.backend not in PROGRAM_BACKENDS:
            continue
        img = _compile_image(w, spec, _path_str(path))
        images[img.path] = img
    return CimaProgram(images=images)


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
