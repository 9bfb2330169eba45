"""Train state.  Port of ``repro.train.state``."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim.adamw import OptState, init_opt_state
from repro_torch.optim.compression import init_error_state
from repro_torch.tree import leaves


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    error: Any                 # gradient-compression error feedback (or None)
    step: torch.Tensor         # int32, on the parameters' device


def init_train_state(params, use_compression: bool = False) -> TrainState:
    opt = init_opt_state(params)
    return TrainState(
        params=params,
        opt=opt,
        error=init_error_state(params) if use_compression else None,
        step=torch.zeros((), dtype=torch.int32, device=opt.count.device),
    )


def state_template(params, use_compression: bool = False) -> TrainState:
    """A TrainState of full shapes that holds no moments: ``params``
    stands in for mu, nu and the error tree.  It is what
    :func:`~repro_torch.distributed.sharding.state_specs` and a
    checkpoint restore read (shapes, dtypes, devices), so a rank of a
    mesh never holds the whole moments."""
    device = next(iter(leaves(params)), torch.zeros(())).device
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return TrainState(params, OptState(params, params, zero),
                      params if use_compression else None, zero)
