"""``repro_torch.tune`` — the trace-once / reprice-many design-space
auto-tuner (DESIGN.md §14).  Port of ``repro.tune``.

The serving design space — VDD corner, per-layer precisions, per-device
bank capacity, ``data x model`` mesh shape, double buffering, plane
skip, datapath fusion — is priced entirely through the chip cost model:
one eager traced decode step captures the logical MVM stream, then
thousands of :class:`Candidate` points are re-evaluated by re-running
the bank allocator and rewriting the records
(:class:`~repro_torch.tune.reprice.TraceCostModel`), never re-executing
the network.  The baseline candidate reprices EXACTLY to
``energy_summary(trace)`` — the tuner ranks candidates with the same
ruler that prices real runs.

    from repro_torch import tune
    result = tune.tune(params, cfg, tune.Candidate(policy=cfg.policy,
                                                   capacity_chips=4))
    engine = Engine(params, result.best.apply_model(cfg),
                    result.best.serve_config(max_seq=128))
"""
from .frontier import pareto_frontier, select_best
from .quality import CifarQuality, NullQuality, SqnrQuality
from .reprice import TraceCostModel
from .space import Candidate, DesignSpace, lm_space, precision_policies
from .tuner import (PAPER_CIFAR_ACCURACY, CifarCandidate, TunedConfig,
                    TuneResult, cifar_space, tune, tune_cifar)

__all__ = [
    "Candidate", "DesignSpace", "lm_space", "precision_policies",
    "TraceCostModel", "NullQuality", "SqnrQuality", "CifarQuality",
    "pareto_frontier", "select_best",
    "TunedConfig", "TuneResult", "tune",
    "CifarCandidate", "cifar_space", "tune_cifar",
    "PAPER_CIFAR_ACCURACY",
]
