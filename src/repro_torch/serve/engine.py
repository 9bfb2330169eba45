"""Batched serving engine: weight-stationary program load, prefill and
greedy (or sampled) decode.  Port of ``repro.serve.engine`` without the
mesh; the continuous batcher comes in a later slice.

At init the engine compiles every quantized projection into a
:class:`~repro_torch.accel.program.CimaImage` and installs it next to its
weight, so decode never re-quantizes a weight.  Every call runs under
``torch.inference_mode()`` and, by default, ``override(x_per_row=True)``:
one input scale per row, so a request's tokens never depend on its batch
neighbours.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.accel import build_program, install_program, override
from repro_torch.models import decode_step, init_cache, prefill

from .host import host_sync


@dataclasses.dataclass
class ServeConfig:
    max_seq: int = 2048
    max_new_tokens: int = 64
    temperature: float = 0.0          # 0 = greedy
    eos_id: int = -1                  # -1 = never stop early
    # how often generate() syncs the all-rows-EOS flag to the host; each
    # check blocks on the in-flight decode
    eos_check_every: int = 4
    seed: int = 0
    # compile every quantized projection's planes once at engine init
    use_program: bool = True
    # one input quantization scale per row (ExecSpec.x_per_row)
    x_per_row: bool = True

    def __post_init__(self):
        for name in ("max_seq", "max_new_tokens", "eos_check_every"):
            v = getattr(self, name)
            if v <= 0:
                raise ValueError(f"ServeConfig.{name} must be positive, "
                                 f"got {v}")
        if self.temperature < 0:
            raise ValueError(f"ServeConfig.temperature must be >= 0, "
                             f"got {self.temperature}")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)


class Engine:
    """Serves ``params`` under ``cfg`` on ``device`` (``cuda`` unless the
    caller asks for the CPU)."""

    def __init__(self, params, cfg, serve_cfg: ServeConfig, device="cuda"):
        self.cfg = cfg
        self.scfg = serve_cfg
        self.device = torch.device(device)
        params = _to_device(params, self.device)
        self.program = None
        if serve_cfg.use_program:
            with torch.inference_mode():
                program = build_program(params, cfg)
            if program:
                self.program = program
                params = install_program(params, program, cfg)
        self.params = params
        # decode steps issued by the last generate() (EOS may stop early)
        self.last_decode_steps = 0

    @contextlib.contextmanager
    def _scope(self) -> Iterator[None]:
        """The serving execution scope: inference mode plus the per-row
        input quantization discipline (unless disabled)."""
        with torch.inference_mode(), contextlib.ExitStack() as stack:
            if self.scfg.x_per_row:
                stack.enter_context(override(x_per_row=True))
            yield

    def prefill(self, prompts: torch.Tensor):
        """Prefill a dense [B, S] batch into a ``max_seq`` cache; returns
        (logits [B, V], cache)."""
        with self._scope():
            return prefill(self.params, prompts, self.cfg, self.scfg.max_seq)

    def decode(self, tok: torch.Tensor, cache):
        """One decode step of the whole batch; returns (logits, cache)."""
        with self._scope():
            return decode_step(self.params, tok, cache, self.cfg)

    def init_cache(self, batch: int):
        """A fresh decode cache at full batch width."""
        return init_cache(self.cfg, batch, self.scfg.max_seq, self.device)

    def sample(self, logits: torch.Tensor, request_ids, steps) -> torch.Tensor:
        """Next tokens [B].  Greedy at temperature 0; otherwise row ``i``
        draws from its own generator, seeded from (seed, request id,
        step), so a request's samples never depend on its neighbours."""
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        out = []
        for i, (rid, step) in enumerate(zip(request_ids, steps)):
            seed = ((self.scfg.seed * 1_000_003 + int(rid)) * 1_000_033
                    + int(step)) % (2 ** 63)
            gen = torch.Generator(device=logits.device).manual_seed(seed)
            probs = torch.softmax(logits[i].to(torch.float32)
                                  / self.scfg.temperature, dim=-1)
            out.append(torch.multinomial(probs, 1, generator=gen))
        return torch.cat(out)

    def generate(self, prompts, request_ids=None) -> np.ndarray:
        """prompts: [B, S] int -> generated tokens [B, max_new_tokens].

        Prompts must be real equal-length sequences (no pad mask here).
        ``request_ids`` (default ``arange(B)``) seed the per-row sampling
        generators."""
        prompts = torch.as_tensor(prompts, device=self.device)
        if prompts.ndim != 2:
            raise ValueError("prompts must be a dense [B, S] batch")
        b = prompts.shape[0]
        eos = self.scfg.eos_id
        rids = np.arange(b) if request_ids is None else np.asarray(request_ids)
        logits, cache = self.prefill(prompts)
        tok = self.sample(logits, rids, np.zeros(b, np.int64))
        out = [tok]
        done = torch.zeros_like(tok, dtype=torch.bool)
        self.last_decode_steps = 0
        check = self.scfg.eos_check_every
        for t in range(1, self.scfg.max_new_tokens):
            if eos >= 0:
                done = done | (tok == eos)
                # every row emitted EOS: stop and pad with eos_id (what the
                # full loop would have produced); polled every `check` steps
                if (t - 1) % check == 0 and bool(host_sync(
                        done, reason="eos early-exit poll, amortized over "
                        "eos_check_every decode steps").all()):
                    break
            logits, cache = self.decode(tok, cache)
            self.last_decode_steps += 1
            nxt = self.sample(logits, rids, np.full(b, t))
            if eos >= 0:
                nxt = torch.where(done, eos, nxt)
            tok = nxt
            out.append(tok)
        gen = host_sync(torch.stack(out, dim=1),
                        reason="end of generate: one batched pull of the "
                        "whole [B, T] token block")
        if gen.shape[1] < self.scfg.max_new_tokens:
            pad = np.full((b, self.scfg.max_new_tokens - gen.shape[1]), eos,
                          gen.dtype)
            gen = np.concatenate([gen, pad], axis=1)
        return gen
