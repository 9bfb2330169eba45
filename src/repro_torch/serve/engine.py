"""Batched serving engine: weight-stationary program load, prefill,
greedy (or sampled) decode, and slot-level continuous batching.  Port of
``repro.serve.engine``.

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

On a ``data x model`` mesh (``ServeConfig.mesh``, a
:class:`~repro_torch.launch.mesh.ServeMesh`; every rank runs the same
calls) the program compiles partitioned: each rank holds only its tile
of every partitioned image, the raw weight behind a tile is released,
and every call runs under the mesh and the program's tiles, so each
projection runs as the rank's tile (:mod:`repro_torch.accel.shard`).
Attention runs on the rank's share where the reference's rule puts the
model axis (``models.attention.head_split``, per call): on the kv heads
or the GQA group, q, k and v stay on their rank, the rank's KV cache
(the dense cache, each slot's, the paged pools) holds its own kv heads
in ``"kv"`` mode, and ``wo``'s row tile takes the rank's heads of the
attention output; on the query rows (``"sq"``) or the head dim
(``"d"``), attention runs on the rank's rows or head dims between the
gathered projections, and where a decode step is ``"d"`` the KV caches
and whisper's cross keys and values (the dense cache, each slot's,
every splice) hold the rank's head-dim slice.  MLA runs on the rank's
q heads (``wq`` and ``w_ukv`` as local column tiles, the latent cache
whole), the SSD mixer on its heads or head dims and the RG-LRU on its
width slice, their states (in every cache, slot and splice) holding
the rank's share (``models.mixer_split``).  Every other activation
stays whole on the model axis.  The data axis splits batch rows: a batch the
data axis divides (``generate``'s prompts, the batchers' slots) is
served by each data shard on its own rows, with its own rows of the
cache, and rows are gathered over the data group only where the host
reads them (sampled tokens, the EOS poll).  A batch it does not divide
(an admission's batch-1 prefill) runs on every data shard, still on the
rank's share of attention.  A MoE layer's expert capacity then counts
one shard's tokens (a dropless capacity factor gives the unsharded
streams).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.accel import (CimaImage, build_program, install_program,
                               override)
from repro_torch.accel.program import tile_bounds
from repro_torch.distributed.autoshard import manual, use_mesh
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
    # multi-device serving: a data x model ServeMesh (launch.mesh.
    # make_serve_mesh).  The program compiles partitioned over "model"
    # (each rank keeps its tile), batch rows and slot state split over
    # "data"; the ShardPolicy is explicit (no module-global policy)
    mesh: Optional[object] = None
    shard_policy: Optional[object] = None

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
        # a policy that declares data_shards must match the actual mesh
        declared = getattr(self.shard_policy, "data_shards", 1)
        if declared > 1:
            if self.mesh is None:
                raise ValueError(
                    f"shard_policy.data_shards={declared} requires a mesh "
                    f"with a 'data' axis, got mesh=None")
            actual = int(dict(self.mesh.shape).get("data", 1))
            if actual != declared:
                raise ValueError(
                    f"shard_policy.data_shards={declared} but the mesh "
                    f"'data' axis has size {actual}")
        # a per-tensor input scale reads the whole batch, which the data
        # axis splits across ranks
        if self.mesh is not None and not self.x_per_row \
                and int(dict(self.mesh.shape).get("data", 1)) > 1:
            raise ValueError("ServeConfig.x_per_row=False needs one input "
                             "scale across the batch, which a data axis "
                             "splits; serve data > 1 with x_per_row=True")

    @classmethod
    def from_tuned(cls, tuned, mesh=None, **kw) -> "ServeConfig":
        """A ``ServeConfig`` from an auto-tuner choice (:class:`repro_torch.
        tune.TunedConfig`): bank capacity and double-buffered streaming
        land here, the model-side knobs (policy, plane skip, datapath
        fusion) through ``tuned.apply_model(cfg)``.  Extra keywords pass
        through to the constructor and override the tuned values.

        A tuned mesh wider than 1x1 needs a ``mesh`` whose ``data``/
        ``model`` sizes match the tuned shape (``launch.mesh.
        make_serve_mesh``): a silent mismatch would serve another design
        point than the tuner priced.  A tuned data axis wider than 1
        attaches a matching :class:`~repro_torch.distributed.sharding.
        ShardPolicy` unless the caller gives one."""
        want = (getattr(tuned, "data_shards", 1),
                getattr(tuned, "model_shards", 1))
        if want != (1, 1):
            if mesh is None:
                raise ValueError(
                    f"tuned config {getattr(tuned, 'label', '')!r} wants a "
                    f"{want[0]}x{want[1]} data x model mesh; pass mesh= "
                    f"(e.g. launch.mesh.make_serve_mesh)")
            shape = dict(mesh.shape)
            have = (int(shape.get("data", 1)), int(shape.get("model", 1)))
            if have != want:
                raise ValueError(
                    f"mesh is {have[0]}x{have[1]} data x model but the "
                    f"tuned config was priced at {want[0]}x{want[1]}")
        if want[0] > 1 and "shard_policy" not in kw:
            from repro_torch.distributed.sharding import ShardPolicy

            kw["shard_policy"] = ShardPolicy(data_shards=want[0])
        kw.setdefault("cima_chips", tuned.capacity_chips)
        kw.setdefault("stream_double_buffer", tuned.double_buffer)
        return cls(mesh=mesh, **kw)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)


def _release_tiled(tree):
    """``tree`` with the raw weight of every projection whose installed
    image is one tile replaced by a ``meta`` tensor of its shape:
    dispatch reads only its shape, and the rank keeps only its tile."""
    if isinstance(tree, dict):
        img = tree.get("cima")
        out = {k: _release_tiled(v) for k, v in tree.items()}
        if isinstance(img, CimaImage) and img.tile is not None \
                and torch.is_tensor(tree.get("w")):
            w = tree["w"]
            out["w"] = torch.empty(w.shape, dtype=w.dtype, device="meta")
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_release_tiled(v) for v in tree)
    return tree


class Engine:
    """Serves ``params`` under ``cfg`` on ``device``: the mesh's device
    with a ``serve_cfg.mesh``, else ``cuda`` unless the caller asks for
    the CPU."""

    def __init__(self, params, cfg, serve_cfg: ServeConfig, device=None):
        self.cfg = cfg
        self.scfg = serve_cfg
        self.mesh = serve_cfg.mesh
        if device is None:
            device = self.mesh.device if self.mesh is not None else "cuda"
        self.device = torch.device(device)
        params = _to_device(params, self.device)
        self.program = None
        # the partition of this rank's program tiles, by policy tag
        self.tiles: dict = {}
        if serve_cfg.use_program:
            with torch.inference_mode():
                program = build_program(
                    params, cfg, capacity_chips=serve_cfg.cima_chips,
                    mesh=self.mesh,
                    double_buffer=serve_cfg.stream_double_buffer)
            if program:
                self.program = program
                params = install_program(params, program, cfg)
                if self.mesh is not None:
                    params = _release_tiled(params)
                    self.tiles = {img.tag: img.partition
                                  for img in program.images.values()
                                  if img.tile is not None}
        self.params = params
        # decode steps issued by the last generate() (EOS may stop early)
        self.last_decode_steps = 0

    @contextlib.contextmanager
    def _scope(self) -> Iterator[None]:
        """The serving execution scope: inference mode, the per-row input
        quantization discipline (unless disabled) and the mesh."""
        with torch.inference_mode(), contextlib.ExitStack() as stack:
            if self.scfg.x_per_row:
                stack.enter_context(override(x_per_row=True))
            if self.mesh is not None:
                stack.enter_context(use_mesh(self.mesh,
                                             self.scfg.shard_policy,
                                             self.tiles))
            yield

    def data_rows(self, batch: int) -> Optional[slice]:
        """This data shard's rows of a ``batch``-row batch, or None where
        the batch does not split (no mesh, a data axis of 1, or one that
        does not divide it: every data shard runs every row)."""
        d = self.mesh.size("data") if self.mesh is not None else 1
        if d <= 1 or batch % d:
            return None
        return slice(*tile_bounds(batch, d, self.mesh.index("data")))

    @contextlib.contextmanager
    def local_rows(self, rows: Optional[slice]) -> Iterator[None]:
        """Scope of calls on this data shard's ``rows`` (from
        :meth:`data_rows`; None: the whole batch, no scope)."""
        with manual("data") if rows is not None else contextlib.nullcontext():
            yield

    def gather_rows(self, t: torch.Tensor, rows: Optional[slice],
                    dim: int = 0) -> torch.Tensor:
        """The whole batch of a per-shard ``t`` (rows on ``dim``)."""
        if rows is None:
            return t
        return self.mesh.all_gather(t, "data", dim)

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
        """A fresh decode cache at full batch width: on a mesh whose data
        axis splits ``batch``, this data shard's rows of it; its KV
        caches (and whisper's cross keys and values) hold the heads or
        head dims this rank serves and its SSM and LRU states the
        rank's share, the layout every prefill of the batchers splices
        into it."""
        rows = self.data_rows(batch)
        n = batch if rows is None else rows.stop - rows.start
        with self._scope():
            return init_cache(self.cfg, n, self.scfg.max_seq, self.device)

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
        generators.  On a mesh whose data axis divides B each data shard
        serves its rows; every rank returns the whole [B, T] block."""
        prompts = torch.as_tensor(prompts, device=self.device)
        if prompts.ndim != 2:
            raise ValueError("prompts must be a dense [B, S] batch")
        b = prompts.shape[0]
        eos = self.scfg.eos_id
        rids = np.arange(b) if request_ids is None else np.asarray(request_ids)
        rows = self.data_rows(b)
        if rows is not None:
            prompts, rids = prompts[rows], rids[rows]
            if frontend_embeds is not None:
                frontend_embeds = frontend_embeds[rows]
        nb = len(rids)
        with self.local_rows(rows):
            logits, cache = self.prefill(prompts, frontend_embeds)
            tok = self.sample(logits, rids, np.zeros(nb, np.int64))
            out = [tok]
            done = torch.zeros_like(tok, dtype=torch.bool)
            self.last_decode_steps = 0
            check = self.scfg.eos_check_every
            for t in range(1, self.scfg.max_new_tokens):
                if eos >= 0:
                    done = done | (tok == eos)
                    # every row emitted EOS: stop and pad with eos_id (what
                    # the full loop would have produced); polled every
                    # `check` steps
                    if (t - 1) % check == 0 and bool(host_sync(
                            self.gather_rows(done, rows),
                            reason="eos early-exit poll, amortized over "
                            "eos_check_every decode steps").all()):
                        break
                logits, cache = self.decode(tok, cache)
                self.last_decode_steps += 1
                nxt = self.sample(logits, rids, np.full(nb, t))
                if eos >= 0:
                    nxt = torch.where(done, eos, nxt)
                tok = nxt
                out.append(tok)
        gen = host_sync(self.gather_rows(torch.stack(out, dim=1), rows),
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
                 device=None):
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
        # on a data axis that divides the slots, this shard's slots
        rows = self.engine.data_rows(b)
        lo, hi = (0, b) if rows is None else (rows.start, rows.stop)
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
                    if lo <= i < hi:
                        with self.engine._scope():
                            cache = splice_slot(cache, slot_cache, i - lo)
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
            with self.engine.local_rows(rows):
                logits, cache = self.engine.decode(
                    torch.as_tensor(cur[lo:hi], device=self.engine.device),
                    cache)
            self.stats["decode_steps"] += 1
            self.stats["slot_steps"] += len(active)
            rids = np.asarray([s.rid if s else 0 for s in slots[lo:hi]])
            steps = np.asarray([s.n_gen if s else 0 for s in slots[lo:hi]])
            toks = host_sync(self.engine.gather_rows(
                self.engine.sample(logits, rids, steps), rows),
                reason="slot-batcher reference loop: one token sync per "
                "decode step by design")
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
