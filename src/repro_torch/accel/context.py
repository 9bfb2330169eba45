"""Execution context, scoped overrides, pad positions and the MVM trace.
Port of ``repro.accel.context``.

* :class:`ExecContext` carries per-call state into a backend: the ADC
  noise generator, a compiled weight image and a fused datapath epilogue.
* :func:`override` rewrites every policy-managed spec at dispatch time
  (``with override(backend="bpbs"): ...`` flips a whole model between
  substrates without rebuilding configs).
* :func:`trace` collects one :class:`MvmRecord` per dispatched matmul,
  and :func:`energy_summary` prices a trace on the chip model
  (:mod:`repro_torch.core.energy`).
* :func:`adc_noise` is the seeded source of ADC noise: every dispatch in
  its scope gets its own ``torch.Generator`` (:func:`next_noise_generator`).
  :func:`snapshot` and :func:`replay` let a recomputed (checkpointed)
  layer see the overrides and draw the noise its forward saw.

PyTorch runs eagerly, so every call dispatches (and records) anew: there
is no trace-time caveat.  The reference's ``lax.scan`` over stacked
layers traces one body and scales its records by the layer count
(:func:`vmapped`); the port's layer loop emits one record per layer
instead, with the same sums per tag.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass
class ExecContext:
    """Runtime state threaded into a backend call."""

    # the source of this call's ADC noise (the reference's PRNG key)
    generator: Optional[torch.Generator] = None
    # compiled weight image (repro_torch.accel.program.CimaImage): when
    # armed the backend consumes stored bit planes instead of quantizing w
    image: Optional[object] = None
    # fused near-memory datapath epilogue (core.datapath.Postreduce)
    post: Optional[object] = None


# ------------------------------------------------------------- overrides

_OVERRIDE_STACK: list[dict] = []


@contextlib.contextmanager
def override(**spec_kw) -> Iterator[None]:
    """Scoped spec rewrite applied to every policy-managed dispatch.
    Nested overrides compose, inner wins per field.  ``spec=None`` calls
    (digital by design) are never rewritten."""
    from .spec import ExecSpec

    fields = {f.name for f in dataclasses.fields(ExecSpec)}
    unknown = set(spec_kw) - fields
    if unknown:
        raise TypeError(
            f"override(): unknown ExecSpec field(s) {sorted(unknown)}; "
            f"valid: {sorted(fields)}")
    _OVERRIDE_STACK.append(dict(spec_kw))
    try:
        yield
    finally:
        _OVERRIDE_STACK.pop()


def current_override() -> dict:
    """The merged override in effect (inner scopes win)."""
    merged: dict = {}
    for frame in _OVERRIDE_STACK:
        merged.update(frame)
    return merged


# ----------------------------------------------------------------- trace

@dataclasses.dataclass(frozen=True)
class MvmRecord:
    """One dispatched MVM: the resolved spec plus its static shape.

    ``program`` marks dispatches served from a compiled
    :class:`~repro_torch.accel.program.CimaImage`.  ``loads`` /
    ``load_segments`` charge the weight-stationary reload schedule: a
    dispatch whose image is *streamed* (not resident under the
    allocator's capacity) rewrites ``load_segments`` 768-b row segments
    per image copy, and ``loads`` counts those copies (scaled by
    :func:`vmapped` like ``calls``).  ``stream_overlap`` marks reloads
    the allocator double-buffered, so :func:`energy_summary` charges
    ``max(compute, load)`` wall cycles per copy, except for the
    ``load_prologue`` copy, the first load of a pass, which has no
    compute to hide behind (never scaled: a pass fills its pipeline
    once).  Load *energy* is always billed in full.
    """

    tag: str          # the layer path the policy resolved (spec.tag)
    backend: str
    n: int            # contraction dim (input vector length), logical
    m: int            # output dim, logical
    ba: int
    bx: int
    calls: int        # number of row-vector MVMs (prod of leading dims)
    program: bool = False   # served from a compiled weight image?
    loads: int = 0          # image-copy reloads charged to this dispatch
    load_segments: int = 0  # 768-b row segments per reload (per device)
    stream_overlap: bool = False
    load_prologue: int = 0
    # mesh mapping of the image (model-axis shards, "col"/"row"/"", and
    # data-axis replicas); one device until the port has a mesh
    devices: int = 1
    partition: str = ""
    data_shards: int = 1
    # fused datapath ops per output element (scale/bias/act/saturate)
    post_ops: int = 0
    # measured inside a trace() scope (one device->host read each): the
    # zero fraction of the quantized input, pad positions excluded, and
    # the all-zero (bank, input-plane) serial steps out of n_banks * bx
    sparsity: Optional[float] = None
    planes_skipped: Optional[int] = None
    planes_total: Optional[int] = None
    # the ambient vmapped() scale at record time (``calls`` and ``loads``
    # are already multiplied by it): the reloads this dispatch would
    # charge if its image streamed
    copies: int = 1


class Trace(list):
    """The record buffer a :func:`trace` scope yields: the
    :class:`MvmRecord` of every dispatch, in dispatch order, plus the VDD
    corner the run was traced for (read by :func:`energy_summary`)."""

    def __init__(self, vdd: Optional[float] = None):
        super().__init__()
        self.vdd = vdd


_TRACE_STACK: list[Trace] = []
_CALL_SCALE_STACK: list[int] = []


@contextlib.contextmanager
def trace(vdd: Optional[float] = None) -> Iterator[Trace]:
    """Collect an :class:`MvmRecord` per dispatched matmul in this scope.
    ``vdd`` stamps the supply corner the run targets onto the yielded
    :class:`Trace` (validated against the chip's measured corners).

    Inside the scope every non-digital dispatch also measures its input
    sparsity and all-zero planes, which reads counts back to the host;
    outside it, dispatch records and measures nothing."""
    if vdd is not None:
        from repro_torch.core.energy import validate_vdd

        validate_vdd(vdd)
    buf = Trace(vdd=vdd)
    _TRACE_STACK.append(buf)
    try:
        yield buf
    finally:
        _TRACE_STACK.pop()


@contextlib.contextmanager
def vmapped(n: int) -> Iterator[None]:
    """Scale recorded ``calls``/``loads``/``copies`` by ``n`` for
    dispatches whose mapped axis the dispatcher cannot see in
    ``x.shape`` (batched MoE experts).  Nested scopes multiply.  The
    port's layer loop dispatches every layer on its own and needs none."""
    _CALL_SCALE_STACK.append(int(n))
    try:
        yield
    finally:
        _CALL_SCALE_STACK.pop()


def record(rec: MvmRecord) -> None:
    if not _TRACE_STACK:
        return
    # mapped instances scale the work (calls, loads) but not the
    # prologue: the double-buffer pipeline fills once per pass
    for n in _CALL_SCALE_STACK:
        rec = dataclasses.replace(rec, calls=rec.calls * n,
                                  loads=rec.loads * n,
                                  copies=rec.copies * n)
    for buf in _TRACE_STACK:
        buf.append(rec)


def streamed_load_seen() -> bool:
    """Has the innermost trace scope already recorded a streamed load?
    The first streamed dispatch of a pass carries the double-buffer
    prologue; a nested trace is a fresh pass."""
    return any(r.loads for r in _TRACE_STACK[-1]) if _TRACE_STACK else False


def tracing() -> bool:
    return bool(_TRACE_STACK)


# ------------------------------------------------------------- ADC noise

_NOISE_STACK: list[list] = []      # frames of [seed, counter, device]


def fold_seed(seed: int, data: int) -> int:
    """A 63-bit seed derived from ``(seed, data)``, the role of the
    reference's ``jax.random.fold_in``: distinct ``data`` give unrelated
    streams (numpy's ``SeedSequence`` hashes the pair)."""
    state = np.random.SeedSequence([int(seed), int(data)]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


@contextlib.contextmanager
def adc_noise(seed: int, device=None) -> Iterator[None]:
    """Scoped, seeded source of ADC noise (``adc_sigma_lsb > 0``).

    Every dispatched matmul in the scope draws from a fresh
    ``torch.Generator`` seeded with ``fold_seed(seed, k)`` for the
    dispatch's counter ``k``, as the reference folds its counter into
    the scope's key: the noise of dispatch ``k`` does not depend on what
    earlier dispatches drew, and the same seed gives the same bits on the
    same device.  ``device`` places the generators (default: each
    dispatch's input device).  The port matches the reference in
    distribution only: torch cannot reproduce JAX's PRNG."""
    _NOISE_STACK.append([int(seed), 0, device])
    try:
        yield
    finally:
        _NOISE_STACK.pop()


def next_noise_generator(device=None) -> Optional[torch.Generator]:
    """A fresh per-dispatch generator from the innermost :func:`adc_noise`
    scope (None outside any), on the scope's device or else ``device``."""
    if not _NOISE_STACK:
        return None
    frame = _NOISE_STACK[-1]
    frame[1] += 1
    dev = torch.device(frame[2] if frame[2] is not None else
                       device if device is not None else "cpu")
    return torch.Generator(device=dev).manual_seed(
        fold_seed(frame[0], frame[1]))


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """The dispatch-time state a recomputed layer must see again: the
    override stack and the innermost noise frame (seed, counter, device)
    as they stood at the layer's entry."""

    overrides: tuple
    noise: Optional[tuple]


def snapshot() -> Snapshot:
    return Snapshot(tuple(dict(f) for f in _OVERRIDE_STACK),
                    tuple(_NOISE_STACK[-1]) if _NOISE_STACK else None)


@contextlib.contextmanager
def replay(snap: Snapshot) -> Iterator[Optional[list]]:
    """Run the enclosed dispatches under ``snap``'s overrides and from its
    noise counter, on a copy of its noise frame (yielded; None without
    one).  A checkpointed layer wraps its body in this: the forward runs
    it in the scope it was taken in, the recomputation in the backward
    (after the scope may have closed) draws the same generators again.
    The live scopes are left as they were."""
    saved = _OVERRIDE_STACK[:], _NOISE_STACK[:]
    frame = list(snap.noise) if snap.noise is not None else None
    _OVERRIDE_STACK[:] = [dict(f) for f in snap.overrides]
    _NOISE_STACK[:] = [frame] if frame is not None else []
    try:
        yield frame
    finally:
        _OVERRIDE_STACK[:], _NOISE_STACK[:] = saved


def advance_noise(counter: int) -> None:
    """Set the innermost noise scope's counter (after a :func:`replay`d
    forward drew on a copy of it)."""
    if _NOISE_STACK:
        _NOISE_STACK[-1][1] = counter


# ------------------------------------------------------------ pad positions

_PAD_STACK: list = []


@contextlib.contextmanager
def pad_positions(mask) -> Iterator[None]:
    """Mark which leading positions of the activations are PADDING
    (``mask`` bool, True = real token), for sparsity accounting that must
    not count left-pad zeros as exploitable input sparsity."""
    _PAD_STACK.append(mask)
    try:
        yield
    finally:
        _PAD_STACK.pop()


def current_pad_mask():
    """The innermost ambient pad mask (None outside any scope)."""
    return _PAD_STACK[-1] if _PAD_STACK else None


# ------------------------------------------------------------- cost model

def energy_summary(records, vdd: Optional[float] = None,
                   sparsity: float = 0.0, readout: str = "adc") -> dict:
    """Chip-model cost of a traced run, from :mod:`repro_torch.core.energy`
    (the 65 nm chip's measured constants, not the card this runs on).

    ``vdd`` resolves in order: the argument, the corner stamped on the
    :class:`Trace` (``trace(vdd=...)``), then 0.85 V; only the chip's
    measured corners are accepted.  ``sparsity`` is the uniform
    input-sparsity assumption for records that measured none; the
    calls-weighted mean of the measured values is ``input_sparsity``.
    Measured ``planes_skipped``/``planes_total`` discount CIMU cycles and
    every per-conversion pJ term (mean: ``plane_skip``).

    Digital records are counted (``mvms``) and cost nothing.  Streamed
    images charge their reloads: ``load_segments`` 768-b row segments
    per copy at ``max(C_A, C_LOAD)`` cycles and ``A_ROW_SEGMENT /
    DMA_WORD`` DMA words each.  Under ``stream_overlap`` each
    non-prologue copy's reload hides ``min(load, compute)`` cycles
    behind compute: ``load_cycles`` stays the full figure, split into
    ``load_cycles_hidden`` and ``load_cycles_exposed``, and only the
    exposed share enters ``total_cycles``; load energy is billed in full.
    ``pj`` totals are system energy (all shards and replicas), ``cycles``
    per-device wall cycles (calls divided over data replicas).  Fused
    epilogues charge ``datapath_out`` pJ per op per logical output
    element (``post_pj``).  Returns totals plus a per-tag breakdown.
    """
    from repro_torch.core import energy as E

    from .program import segment_cycles, segment_dma_words

    if vdd is None:
        vdd = getattr(records, "vdd", None)
        vdd = 0.85 if vdd is None else vdd
    E.validate_vdd(vdd)

    seg_cycles = segment_cycles()
    seg_words = segment_dma_words()
    e_dma = E.ENERGY_PJ[vdd]["dma_32b"]
    e_post = E.ENERGY_PJ[vdd]["datapath_out"]

    by_tag: dict[str, dict] = {}
    total_pj = 0.0
    total_cycles = 0
    load_pj = 0.0
    load_cycles = 0
    load_hidden = 0
    load_exposed = 0
    post_pj = 0.0
    sp_weight = 0
    sp_sum = 0.0
    skip_weight = 0
    skip_sum = 0.0
    for r in records:
        row = by_tag.setdefault(
            r.tag or r.backend,
            {"backend": r.backend, "mvms": 0, "pj": 0.0, "cycles": 0,
             "load_cycles": 0, "load_cycles_hidden": 0,
             "load_cycles_exposed": 0, "post_pj": 0.0})
        row["mvms"] += r.calls
        if r.backend == "digital":
            continue
        d_sh = max(r.devices, 1)
        d_dp = max(r.data_shards, 1)
        n_loc = r.n // d_sh if r.partition == "row" else r.n
        m_loc = r.m // d_sh if r.partition == "col" else r.m
        shape = E.MvmShape(n=n_loc, m=m_loc, ba=r.ba, bx=r.bx)
        if r.sparsity is not None:
            sp_sum += r.sparsity * r.calls
            sp_weight += r.calls
        skip = 0.0
        if r.planes_skipped is not None and r.planes_total:
            skip = r.planes_skipped / r.planes_total
            skip_sum += skip * r.calls
            skip_weight += r.calls
        pj = E.mvm_energy_pj(shape, vdd,
                             sparsity if r.sparsity is None else r.sparsity,
                             readout, plane_skip=skip)["total"] \
            * r.calls * d_sh
        calls_dev = -(-r.calls // d_dp)
        cyc = E.mvm_cycles(shape, readout, plane_skip=skip) * calls_dev
        if r.loads:
            segs = r.loads * r.load_segments       # per-device segments
            lc = segs * seg_cycles                 # per-device DMA cycles
            lp = segs * seg_words * e_dma * d_sh * d_dp   # system energy
            hidden = 0
            if r.stream_overlap:
                # each non-prologue copy's load runs during one copy's
                # compute window and hides min(load, compute) of it
                lc_copy = r.load_segments * seg_cycles
                cc_copy = cyc // r.loads
                p = min(max(r.load_prologue, 0), r.loads)
                hidden = (r.loads - p) * min(lc_copy, cc_copy)
            exposed = lc - hidden
            row["load_cycles"] += lc
            row["load_cycles_hidden"] += hidden
            row["load_cycles_exposed"] += exposed
            load_cycles += lc
            load_hidden += hidden
            load_exposed += exposed
            load_pj += lp
            pj += lp
            cyc += exposed
        if r.post_ops:
            pp = r.post_ops * r.m * r.calls * e_post
            row["post_pj"] += pp
            post_pj += pp
            pj += pp
        row["pj"] += pj
        row["cycles"] += cyc
        total_pj += pj
        total_cycles += cyc
    return {"vdd": vdd,
            "total_pj": total_pj, "total_cycles": total_cycles,
            "load_pj": load_pj, "load_cycles": load_cycles,
            "load_cycles_hidden": load_hidden,
            "load_cycles_exposed": load_exposed,
            "post_pj": post_pj,
            "input_sparsity": (sp_sum / sp_weight if sp_weight else None),
            "plane_skip": (skip_sum / skip_weight if skip_weight else None),
            "by_tag": by_tag}
