"""Batched serving engine: weight-stationary program load, prefill,
greedy (or sampled) decode, and slot-level continuous batching.  Port of
``repro.serve.engine`` without the mesh.

:class:`ContinuousBatcher` keeps a fixed pool of batch slots.  Decode
always runs at full batch width, and ``DecodeCache.pos`` is per slot, so
slots at different sequence lengths share one device step.  A finished
slot (EOS or token budget) is retired and refilled alone: the new request
is left-padded to a power-of-two bucket, prefilled with a pad mask, and
its batch-1 cache is spliced into the live batch cache in place.

At init the engine compiles every quantized projection into a
:class:`~repro_torch.accel.program.CimaImage` and installs it next to its
weight, so decode never re-quantizes a weight; with ``cima_chips`` below
the model's footprint the allocator streams the tail, which a
``trace()`` charges and the tokens never see.  Every call runs under
``torch.inference_mode()`` and, by default, ``override(x_per_row=True)``:
one input scale per row, so a request's tokens never depend on its batch
neighbours.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.accel import build_program, install_program, override
from repro_torch.models import decode_step, init_cache, prefill, splice_slot

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
    # compile every quantized projection's planes once at engine init;
    # cima_chips bounds the standing allocation (N x 590kb arrays, None =
    # everything resident) and the overflow streams every pass
    use_program: bool = True
    cima_chips: Optional[int] = None
    # double-buffer the streamed images' reloads behind compute (the
    # trace's wall cycles; accounting only, tokens are the same)
    stream_double_buffer: bool = True
    # one input quantization scale per row (ExecSpec.x_per_row)
    x_per_row: bool = True
    # paged serving (serve.kv, serve.scheduler): positions per block of
    # the shared cache pool; decode steps a PagedScheduler block runs
    # between its host syncs; admission prefill chunk width (None = the
    # whole prompt at once, exact for every arch)
    kv_block_size: int = 16
    decode_block: int = 8
    prefill_chunk: Optional[int] = None
    # admission prefills per ContinuousBatcher decode step, so an arrival
    # burst cannot stall the live slots behind a run of prefills
    # (None = admit greedily)
    max_admit_per_step: Optional[int] = 1

    def __post_init__(self):
        for name in ("max_seq", "max_new_tokens", "eos_check_every",
                     "kv_block_size", "decode_block"):
            v = getattr(self, name)
            if v <= 0:
                raise ValueError(f"ServeConfig.{name} must be positive, "
                                 f"got {v}")
        if self.max_seq % self.kv_block_size:
            raise ValueError(
                f"ServeConfig.kv_block_size={self.kv_block_size} must "
                f"divide the cache capacity max_seq={self.max_seq}")
        if self.prefill_chunk is not None and self.prefill_chunk <= 0:
            raise ValueError(f"ServeConfig.prefill_chunk must be positive "
                             f"or None, got {self.prefill_chunk}")
        cap = self.max_admit_per_step
        if cap is not None and cap <= 0:
            raise ValueError(f"ServeConfig.max_admit_per_step must be "
                             f"positive or None, got {cap}")
        if self.temperature < 0:
            raise ValueError(f"ServeConfig.temperature must be >= 0, "
                             f"got {self.temperature}")

    @classmethod
    def from_tuned(cls, tuned, mesh=None, **kw) -> "ServeConfig":
        """A ``ServeConfig`` from an auto-tuner choice (:class:`repro_torch.
        tune.TunedConfig`): bank capacity and double-buffered streaming
        land here, the model-side knobs (policy, plane skip, datapath
        fusion) through ``tuned.apply_model(cfg)``.  Extra keywords pass
        through to the constructor and override the tuned values.

        A tuned mesh wider than 1x1 needs a ``mesh`` of that shape, as in
        the reference; serving on one is the port's multi-device slice,
        so with a mesh it raises ``NotImplementedError``."""
        want = (getattr(tuned, "data_shards", 1),
                getattr(tuned, "model_shards", 1))
        if want != (1, 1):
            if mesh is None:
                raise ValueError(
                    f"tuned config {getattr(tuned, 'label', '')!r} wants a "
                    f"{want[0]}x{want[1]} data x model mesh; pass mesh=")
            raise NotImplementedError(
                f"serving the tuned {want[0]}x{want[1]} data x model mesh "
                "waits for the port's multi-device slice")
        kw.setdefault("cima_chips", tuned.capacity_chips)
        kw.setdefault("stream_double_buffer", tuned.double_buffer)
        return cls(**kw)


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
                program = build_program(
                    params, cfg, capacity_chips=serve_cfg.cima_chips,
                    double_buffer=serve_cfg.stream_double_buffer)
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

    def prefill(self, prompts: torch.Tensor, frontend_embeds=None):
        """Prefill a dense [B, S] batch into a ``max_seq`` cache; returns
        (logits [B, V], cache).  ``frontend_embeds`` [B, F, d]: the
        frontend stub's patch or frame embeddings (an early-fusion
        decoder's first F positions, whisper's encoder input)."""
        if frontend_embeds is not None:
            frontend_embeds = torch.as_tensor(frontend_embeds,
                                              device=self.device)
        with self._scope():
            return prefill(self.params, prompts, self.cfg, self.scfg.max_seq,
                           frontend_embeds=frontend_embeds)

    def prefill_single(self, prompt):
        """Pad-masked batch-1 prefill of ``prompt`` (1-D ints), left-padded
        to a power-of-two bucket length; returns (logits [1, V], batch-1
        cache).  The admission path of the batcher: it passes no frontend
        embeddings, so whisper encodes zeros for every admitted slot, as
        in the reference."""
        n = len(prompt)
        sb = min(max(_bucket(n), n), self.scfg.max_seq)
        toks = torch.zeros((1, sb), dtype=torch.int64)
        mask = torch.zeros((1, sb), dtype=torch.bool)
        toks[0, sb - n:] = torch.as_tensor(np.asarray(prompt, np.int64))
        mask[0, sb - n:] = True
        with self._scope():
            return prefill(self.params, toks.to(self.device), self.cfg,
                           self.scfg.max_seq,
                           pad_mask=mask.to(self.device))

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

    def generate(self, prompts, frontend_embeds=None,
                 request_ids=None) -> np.ndarray:
        """prompts: [B, S] int -> generated tokens [B, max_new_tokens].

        Prompts must be real equal-length sequences (no pad mask here).
        ``frontend_embeds`` go to the prefill (:meth:`prefill`).
        ``request_ids`` (default ``arange(B)``) seed the per-row sampling
        generators."""
        prompts = torch.as_tensor(prompts, device=self.device)
        if prompts.ndim != 2:
            raise ValueError("prompts must be a dense [B, S] batch")
        b = prompts.shape[0]
        eos = self.scfg.eos_id
        rids = np.arange(b) if request_ids is None else np.asarray(request_ids)
        logits, cache = self.prefill(prompts, frontend_embeds)
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


def _bucket(n: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class _Slot:
    rid: int
    budget: int
    n_gen: int


_Request = collections.namedtuple("_Request", "rid prompt budget")


class ContinuousBatcher:
    """Slot-level continuous batching over a fixed decode batch.

    ``run()`` drives one persistent decode loop: every iteration is one
    full-width decode step; finished slots (per-slot EOS or token budget)
    are retired between steps and refilled from the pending queue by
    prefilling ONLY that request (left-padded to a power-of-two bucket,
    pad-masked) and splicing its batch-1 cache into the live batch cache
    in place (whisper's cross keys and values with the rest of it).

    ``stats`` after a run: ``decode_steps`` (batched model steps),
    ``slot_steps`` (sum of active slots over those steps; utilisation is
    ``slot_steps / (decode_steps * n_slots)``), ``prefills`` and
    ``generated_tokens``.

    A MoE model's expert capacity is shared by the tokens of one step
    (idle rows and pads included), so under a tight
    ``moe_capacity_factor`` a slot's stream may differ from its solo
    ``generate``, as in the reference; a dropless factor makes them
    equal.
    """

    def __init__(self, params, cfg, serve_cfg: ServeConfig, n_slots: int,
                 device="cuda"):
        if n_slots <= 0:
            raise ValueError(f"n_slots must be positive, got {n_slots}")
        self.engine = Engine(params, cfg, serve_cfg, device)
        self.cfg, self.scfg = cfg, serve_cfg
        self.n_slots = n_slots
        self.pending: collections.deque[_Request] = collections.deque()
        self.results: dict[int, list[int]] = {}
        self.stats = {"decode_steps": 0, "slot_steps": 0, "prefills": 0,
                      "generated_tokens": 0}
        self._next_id = 0

    def submit(self, prompt, max_new_tokens: Optional[int] = None) -> int:
        """Queue a request; returns its id.  ``max_new_tokens`` overrides
        the ServeConfig budget per request (ragged output lengths)."""
        if len(prompt) > self.scfg.max_seq:
            raise ValueError(f"prompt of {len(prompt)} tokens exceeds "
                             f"max_seq={self.scfg.max_seq}")
        rid = self._next_id
        self._next_id += 1
        budget = (self.scfg.max_new_tokens if max_new_tokens is None
                  else max_new_tokens)
        self.pending.append(_Request(rid, np.asarray(prompt, np.int64),
                                     budget))
        return rid

    # ------------------------------------------------------------ slot path

    def _prefill_request(self, req: _Request):
        """Single-request pad-masked prefill at a bucketed length; returns
        (first sampled token, batch-1 cache)."""
        logits, cache = self.engine.prefill_single(req.prompt)
        self.stats["prefills"] += 1
        tok = self.engine.sample(logits, np.asarray([req.rid]),
                                 np.zeros(1, np.int64))
        return int(host_sync(tok, reason="admission: the first sampled "
                             "token decides retire-vs-splice")[0]), cache

    def run(self, on_token: Optional[Callable[[int, int], None]] = None,
            feed: Optional[Callable[[], bool]] = None
            ) -> dict[int, list[int]]:
        """Serve the queue to completion; returns {rid: tokens} (tokens end
        at EOS inclusive, or at the request's budget).  ``on_token(rid,
        token)`` streams every generated token as it is sampled.  ``feed``
        (if given) is called once per loop iteration to inject arrivals
        via ``submit``; while it returns True the loop keeps polling
        instead of exiting when both queue and slots drain."""
        b = self.n_slots
        eos = self.scfg.eos_id
        with self.engine._scope():
            cache = self.engine.init_cache(b)
        cur = np.zeros(b, np.int64)
        slots: list[Optional[_Slot]] = [None] * b
        emitted: dict[int, list[int]] = {}
        feeding = feed is not None

        def emit(rid, tok):
            emitted[rid].append(tok)
            self.stats["generated_tokens"] += 1
            if on_token is not None:
                on_token(rid, tok)

        while True:
            if feeding:
                feeding = bool(feed())
            cap = self.scfg.max_admit_per_step
            admitted = 0
            for i in range(b):
                while (slots[i] is None and self.pending
                       and (cap is None or admitted < cap)):
                    req = self.pending.popleft()
                    if req.budget <= 0:
                        self.results[req.rid] = []
                        continue
                    tok, slot_cache = self._prefill_request(req)
                    admitted += 1
                    emitted[req.rid] = []
                    emit(req.rid, tok)
                    if (eos >= 0 and tok == eos) or req.budget <= 1:
                        self.results[req.rid] = emitted.pop(req.rid)
                        continue        # retired at its first token
                    with self.engine._scope():
                        cache = splice_slot(cache, slot_cache, i)
                    cur[i] = tok
                    slots[i] = _Slot(req.rid, req.budget, 1)
            active = [i for i in range(b) if slots[i] is not None]
            if not active:
                if self.pending:
                    continue           # capped admission left work queued
                if feeding:
                    time.sleep(5e-4)   # idle but arrivals may still come
                    continue
                break

            # one fixed-width decode step for every slot (idle rows ride
            # along; their samples are discarded)
            logits, cache = self.engine.decode(
                torch.as_tensor(cur, device=self.engine.device), cache)
            self.stats["decode_steps"] += 1
            self.stats["slot_steps"] += len(active)
            rids = np.asarray([s.rid if s else 0 for s in slots])
            steps = np.asarray([s.n_gen if s else 0 for s in slots])
            toks = host_sync(self.engine.sample(logits, rids, steps),
                             reason="slot-batcher reference loop: one "
                             "token sync per decode step by design")
            for i in active:
                s = slots[i]
                tok = int(toks[i])
                cur[i] = tok
                s.n_gen += 1
                emit(s.rid, tok)
                if (eos >= 0 and tok == eos) or s.n_gen >= s.budget:
                    self.results[s.rid] = emitted.pop(s.rid)
                    slots[i] = None
        return self.results

    # --------------------------------------------------- generational baseline

    def run_generational(self) -> dict[int, list[int]]:
        """The pre-splice baseline, kept for utilisation benchmarking:
        drain the queue in equal-length waves of ``n_slots`` (bucketed by
        prompt length so prefill stays exact without a pad mask).  Every
        wave decodes the full ``max_new_tokens`` budget even after its
        short requests finish."""
        while self.pending:
            by_len: dict[int, list[_Request]] = {}
            while self.pending:
                req = self.pending.popleft()
                by_len.setdefault(len(req.prompt), []).append(req)
            for _, group in sorted(by_len.items()):
                for j in range(0, len(group), self.n_slots):
                    wave = group[j: j + self.n_slots]
                    toks = np.stack([r.prompt for r in wave])
                    rids = np.asarray([r.rid for r in wave])
                    gen = self.engine.generate(toks, request_ids=rids)
                    self.stats["prefills"] += 1
                    self.stats["decode_steps"] += self.engine.last_decode_steps
                    self.stats["slot_steps"] += \
                        len(wave) * self.engine.last_decode_steps
                    for r, seq in zip(wave, gen):
                        seq = seq.tolist()[: r.budget]
                        if self.scfg.eos_id >= 0 and self.scfg.eos_id in seq:
                            seq = seq[: seq.index(self.scfg.eos_id) + 1]
                        self.stats["generated_tokens"] += len(seq)
                        self.results[r.rid] = seq
        return self.results
