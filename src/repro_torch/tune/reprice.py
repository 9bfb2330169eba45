"""Trace-once / reprice-many: the analytical cost model behind the tuner.
Port of ``repro.tune.reprice``.

The expensive thing about evaluating a serving configuration is running
the network.  But the chip cost model (:func:`repro_torch.accel.context.
energy_summary`) never looks at an activation value — it prices a list of
:class:`~repro_torch.accel.context.MvmRecord`, and everything a design knob
changes about those records is *static*: the resolved precision, the bank
allocator's residency/partition decisions, the double-buffer schedule,
the VDD corner.  So :class:`TraceCostModel` captures the logical record
stream ONCE (one eager decode step under ``accel.trace``) and re-prices
every candidate by

1. re-running the factored bank allocator
   (:func:`repro_torch.accel.program.plan_allocation`) against the model's
   fixed :class:`~repro_torch.accel.program.ImageFootprint` list, and
2. rewriting each traced record to the candidate's resolved spec and
   placement (``dataclasses.replace`` — no network execution, no weight
   touched), then
3. calling the *real* ``energy_summary`` on the rewritten stream.

For the baseline candidate every rewrite is the identity, so the repriced
cost equals ``energy_summary(trace)`` EXACTLY — float for float.  That is
the correctness anchor the tests pin: the tuner prices candidates with
the same code that prices real runs, not a parallel model that can drift.

Measured-data fields (``sparsity``, ``planes_skipped/planes_total``) ride
along unchanged: the input *data* does not change with the candidate, and
the skipped-plane FRACTION is approximately precision-invariant (an
all-zero input column is all-zero in every bit plane at any B_X).  This
makes precision moves the one *approximate* axis: re-quantizing a layer's
weights or inputs perturbs every downstream activation, so a real run at
the new precision would measure slightly different sparsity/plane
statistics on deeper layers (observed drift ~0.01% of total pJ; cycles
and every allocator-driven term stay exact).  Placement, mesh, corner,
and buffering knobs do not touch the data and reprice exactly.  A
candidate that disables the plane-skip controller drops the fields
instead.  The one knob that cannot be repriced from a fused trace is
"add fusion to an unfused run" — post-op records carry the work only if
the trace ran fused, so trace the baseline with ``fuse_datapath=True``
(the default) and let unfused candidates pay the round-trip penalty.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.accel import energy_summary, plan_allocation
from repro_torch.core import energy as E
from repro_torch.core.datapath import output_bits

from .space import Candidate


@dataclasses.dataclass
class TraceCostModel:
    """Reprices serving candidates from one captured record stream.

    ``records`` is the trace of ONE serving step (e.g. one batched decode
    step) under the baseline candidate's program; ``footprints`` the
    model's allocator input (:func:`~repro_torch.accel.program.
    model_footprint`); ``tokens_per_step`` the tokens that step served
    PER DATA REPLICA (the batch size — candidates with ``data_shards=d``
    serve ``d`` times as many).  The baseline must be traced at
    ``data_shards=1``: the data axis is pure replication, so every other
    data width is derived, never traced.
    """

    records: list                 # list[MvmRecord] (one serving step)
    footprints: list              # list[ImageFootprint]
    tokens_per_step: int
    baseline: Candidate

    def __post_init__(self):
        if self.baseline.data_shards != 1:
            raise ValueError(
                "trace the baseline at data_shards=1; wider data meshes "
                "are derived by replication, never traced")
        tags = [fp.tag for fp in self.footprints]
        dup = {t for t in tags if tags.count(t) > 1}
        if dup:
            # record->placement matching is by policy tag; two
            # projections sharing a tag could land in different
            # residency classes and the rewrite would be ambiguous
            raise ValueError(
                f"footprint tags must be unique to reprice a trace; "
                f"duplicated: {sorted(dup)}")

    # ------------------------------------------------------------ pricing

    def reprice(self, cand: Candidate, readout: str = "adc") -> dict:
        """The chip cost of ``cand``, from the captured trace alone.

        Runs the allocator, rewrites the records, prices them with the
        real ``energy_summary``, and derives the serving metrics the
        frontier ranks on.  Never executes the network.
        """
        plan = plan_allocation(
            self.footprints, cand.policy,
            capacity_chips=cand.capacity_chips,
            model_shards=cand.model_shards,
            data_shards=cand.data_shards,
            double_buffer=cand.double_buffer)
        by_tag = {pl.footprint.tag: pl for pl in plan.values()}
        spec_by_tag = {fp.tag: cand.policy.resolve(fp.tag, kind=fp.kind)
                       for fp in self.footprints}

        new = []
        streamed_seen = False
        unfused_pj = 0.0
        unfused_cycles = 0
        d = cand.data_shards
        for r in self.records:
            spec = spec_by_tag.get(r.tag)
            if spec is None:
                # not a managed projection (shouldn't happen for traced
                # model code, but stay total): scale the served rows,
                # keep the rest
                new.append(dataclasses.replace(r, calls=r.calls * d))
                continue
            pl = by_tag.get(r.tag)          # None => digital by policy
            kw = dict(backend=spec.backend, ba=spec.ba, bx=spec.bx,
                      calls=r.calls * d, data_shards=d)
            if pl is not None:
                streamed = not pl.resident
                prologue = 1 if (pl.overlap and streamed
                                 and not streamed_seen) else 0
                kw.update(
                    program=True,
                    # loads-if-streamed == the vmapped copy count, which
                    # is exactly what the traced ``loads`` equals
                    # whenever the image actually streamed
                    loads=r.copies if streamed else 0,
                    load_segments=pl.segments if streamed else 0,
                    stream_overlap=streamed and pl.overlap,
                    load_prologue=prologue,
                    devices=pl.devices,
                    partition=pl.partition or "")
                if streamed:
                    streamed_seen = True
            else:
                kw.update(program=False, loads=0, load_segments=0,
                          stream_overlap=False, load_prologue=0,
                          devices=1, partition="")
            if not cand.skip_zero_planes:
                kw.update(planes_skipped=None, planes_total=None)
            if r.post_ops and not cand.fuse_datapath:
                pj, cyc = self._unfused_penalty(r, spec, kw, cand)
                unfused_pj += pj
                unfused_cycles += cyc
            new.append(dataclasses.replace(r, **kw))

        es = energy_summary(new, vdd=cand.vdd, readout=readout)
        # the penalty rides OUTSIDE the summary dict: ``summary`` stays
        # byte-identical to what energy_summary(trace) returns for the
        # baseline (the exactness anchor), the derived metrics carry it
        return self._metrics(cand, es, unfused_pj, unfused_cycles)

    @staticmethod
    def _unfused_penalty(r, spec, kw: dict, cand: Candidate) -> tuple:
        """DMA cost of UNFUSING this record's post-reduce pipeline.

        The arithmetic itself is unchanged (the datapath ops run either
        way, and stay priced through ``post_ops``); what fusion removes
        is the memory round trip between reduce and post-ops (paper
        Fig. 8).  Unfused, each of the ``post_ops`` pipeline stages
        stores and reloads the output vector: ``2 * ceil(m * B_y / 32)``
        32-b DMA words per call, system energy over all logical calls,
        wall cycles over the per-device local slice at one word/cycle.
        """
        by = output_bits(spec.bx, spec.ba)
        words = math.ceil(r.m * by / 32)
        m_loc = r.m // kw["devices"] if kw["partition"] == "col" else r.m
        words_loc = math.ceil(m_loc * by / 32)
        e_dma = E.ENERGY_PJ[cand.vdd]["dma_32b"]
        calls = kw["calls"]
        calls_dev = -(-calls // cand.data_shards)
        pj = r.post_ops * 2 * words * e_dma * calls
        cycles = r.post_ops * 2 * words_loc * calls_dev
        return pj, cycles

    def _metrics(self, cand: Candidate, es: dict,
                 unfused_pj: float = 0.0, unfused_cycles: int = 0) -> dict:
        tokens = self.tokens_per_step * cand.data_shards
        cycles = es["total_cycles"] + unfused_cycles
        pj = es["total_pj"] + unfused_pj
        fclk = E.F_CLK[cand.vdd]
        return {
            "candidate": cand.describe(),
            "tokens_per_step": tokens,
            "cycles_per_step": cycles,
            "tokens_per_mcycle": tokens * 1e6 / cycles if cycles else
                float("inf"),
            "tokens_per_s": tokens * fclk / cycles if cycles else
                float("inf"),
            "uj_per_token": pj / tokens / 1e6,
            "pj_per_step": pj,
            "unfused_dma_pj": unfused_pj,
            "unfused_dma_cycles": unfused_cycles,
            "total_chips": cand.total_chips,
            "summary": es,
        }
