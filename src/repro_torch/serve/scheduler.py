"""Request scheduler over the paged KV cache.  Port of
``repro.serve.scheduler``.

Where :class:`~repro_torch.serve.engine.ContinuousBatcher` syncs the
host once per decode step to retire and refill slots, the paged
scheduler batches everything the host must decide:

* **decode blocks**: ``decode_block`` steps (sampling included) run back
  to back on the device between one gather of the dense cache view from
  the pools and one scatter of the touched blocks.  The only device to
  host sync is one ``[K, B]`` token read per block, after which
  retirement and admission for all K steps are decided together.
* **chunked prefill**: admission prefills advance one chunk
  (``prefill_chunk``) per scheduler iteration, so a long prompt
  interleaves with decode blocks.  The first chunk takes the remainder,
  later chunks run :func:`repro_torch.models.prefill_resume` on the
  carried batch-1 cache.  A resumed prefill is ``allclose`` to a whole
  one, not bitwise; the default ``prefill_chunk=None`` is exact.
* **priorities and budgets**: the admission queue is a heap on
  ``(priority, arrival)``; each request carries its own token budget.
* **block backpressure**: an admission that needs more blocks than the
  free list holds is *deferred*; a decode block that cannot extend its
  rows preempts the least urgent row by *recompute* (its prompt and
  emitted tokens re-enter the prefill queue; sampling is a function of
  (request id, step), so the resumed stream continues identically).

Unwritten pool positions gather as exact zeros, so the dense view each
block consumes is bit for bit the slot batcher's contiguous cache, and
the streams equal the slot batcher's token for token.

On a mesh (``ServeConfig.mesh``) every rank runs the same host loop.
Where the data axis divides ``n_slots`` each data shard holds the slot
state and positions of its own slots (``paged_cache_specs``' "data"
entries) and decodes only them, and the block's tokens are gathered over
the data group before the host reads them.  The pools keep the whole
block-id space on every data shard (one global allocator hands any slot
any block): a shard writes and reads only its own slots' blocks.
Admission prefills run on every rank; the splice lands on the shard that
holds the slot.  Where attention runs on the rank's own heads or head
dims (``models.attention.head_split``), the pools, the gathered view,
the scatter and the splice hold the rank's kv heads or head-dim slice,
and the slot states the rank's share of the SSD and RG-LRU states
(``models.mixer_split``; the layout probe runs in the engine's scope),
so the pools' bytes
and the allocator's audit are the rank's; block ids, deferrals and
preemptions are the unsharded scheduler's, and the streams equal the
slot batcher's.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.analysis.sanitize import active as _san_active
from repro_torch.models import decode_step, prefill_resume

from . import kv
from .engine import Engine, ServeConfig
from .host import host_sync


@dataclasses.dataclass
class _PagedReq:
    rid: int
    prompt: np.ndarray            # prompt (+ replayed tokens on resume)
    budget: int
    priority: int
    seq: int                      # arrival order, breaks priority ties
    n_done: int = 0               # prompt tokens prefilled so far
    cache: object = None          # batch-1 working cache between chunks
    first_tok: Optional[int] = None
    gen_done: int = 0             # tokens already emitted (preempt resume)

    def __lt__(self, other):      # heap order: urgent first, then arrival
        return (self.priority, self.seq) < (other.priority, other.seq)


@dataclasses.dataclass
class _PSlot:
    req: _PagedReq
    n_gen: int
    cur: int


class PagedScheduler:
    """Serve an admission queue over one shared paged cache pool on
    ``device`` (``cuda`` unless the caller asks for the CPU).

    ``num_blocks`` defaults to full residency (``n_slots`` x table width:
    no paging pressure, a pure layout change); fewer blocks oversubscribe
    the pool and exercise deferral and preemption.
    """

    def __init__(self, params, cfg, serve_cfg: ServeConfig, n_slots: int,
                 num_blocks: Optional[int] = None, device=None):
        if n_slots <= 0:
            raise ValueError(f"n_slots must be positive, got {n_slots}")
        if cfg.is_encdec:
            raise NotImplementedError("PagedScheduler does not support "
                                      "encoder-decoder archs (cross_kv)")
        self.engine = Engine(params, cfg, serve_cfg, device)
        self.params, self.cfg, self.scfg = self.engine.params, cfg, serve_cfg
        self.device = self.engine.device
        self.n_slots = n_slots
        # probed in the engine's scope: on a mesh the pools hold the
        # heads this rank serves
        with self.engine._scope():
            self.layout = kv.build_layout(cfg, n_slots, serve_cfg.max_seq,
                                          serve_cfg.kv_block_size, num_blocks)
        self.alloc = kv.BlockAllocator(self.layout.num_blocks)
        # on a data axis that divides the slots, this shard's slots: the
        # device layout holds them over the whole block-id space
        mesh = self.engine.mesh
        dsize = mesh.size("data") if mesh is not None else 1
        if dsize > 1 and n_slots % dsize:
            import warnings
            warnings.warn(
                f"n_slots={n_slots} is not divisible by the mesh "
                f"'data' axis ({dsize}): slot state and positions "
                f"replicate instead of sharding — size the slot pool "
                f"as a multiple of data for the intended capacity",
                stacklevel=2)
        self._rows = self.engine.data_rows(n_slots)
        self._lo, self._hi = ((0, n_slots) if self._rows is None
                              else (self._rows.start, self._rows.stop))
        with self.engine._scope():
            self._local = self.layout if self._rows is None else \
                kv.build_layout(cfg, self._hi - self._lo, serve_cfg.max_seq,
                                serve_cfg.kv_block_size,
                                self.layout.num_blocks)
            self.paged = kv.init_paged_cache(self._local, self.device)
        # host-side mirrors: the scheduler owns block placement
        self.tables = np.full((n_slots, self.layout.table_width),
                              self.layout.sentinel, np.int32)
        self._row_blocks: list[list[int]] = [[] for _ in range(n_slots)]
        self._pos_host = [0] * n_slots
        self.slots: list[Optional[_PSlot]] = [None] * n_slots

        # chunked prefill only where the resume path is safe: a windowed
        # ring cache can wrap within one multi-token resume chunk
        self._chunk = serve_cfg.prefill_chunk
        if (self._chunk is not None and cfg.attn_window is not None
                and cfg.attn_window <= serve_cfg.max_seq):
            self._chunk = None

        self._pending: list[_PagedReq] = []      # heap
        self._prefilling: Optional[_PagedReq] = None
        self._ready: Optional[_PagedReq] = None  # prefilled, awaiting blocks
        self.results: dict[int, list[int]] = {}
        self._emitted: dict[int, list[int]] = {}
        self._on_token: Optional[Callable[[int, int], None]] = None
        self._next_id = 0
        self._next_seq = 0
        self.stats = {"decode_blocks": 0, "decode_steps": 0, "slot_steps": 0,
                      "prefills": 0, "prefill_chunks": 0,
                      "generated_tokens": 0, "deferred_admissions": 0,
                      "preemptions": 0}

    def _upload(self, a) -> torch.Tensor:
        """A host int array as an int64 device tensor.  On the card the
        copy goes through pinned memory without blocking the host (a copy
        from pageable memory synchronises)."""
        t = torch.tensor(np.asarray(a), dtype=torch.int64)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    # ------------------------------------------------------------- intake

    def submit(self, prompt: np.ndarray,
               max_new_tokens: Optional[int] = None,
               priority: int = 0) -> int:
        """Queue a request; lower ``priority`` admits first.  Raises if the
        request could never fit the block pool on its own: anything that
        *can* fit is deferred, never dropped."""
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) > self.scfg.max_seq:
            raise ValueError(f"prompt length {len(prompt)} exceeds "
                             f"max_seq={self.scfg.max_seq}")
        budget = (self.scfg.max_new_tokens if max_new_tokens is None
                  else max_new_tokens)
        need = kv.required_blocks(len(prompt) + max(budget - 1, 0),
                                  self.layout)
        if need > self.layout.num_blocks:
            raise ValueError(
                f"request needs {need} blocks but the pool has only "
                f"{self.layout.num_blocks}; raise num_blocks or shrink the "
                f"prompt/budget")
        rid = self._next_id
        self._next_id += 1
        req = _PagedReq(rid, prompt, budget, priority, self._next_seq)
        self._next_seq += 1
        heapq.heappush(self._pending, req)
        return rid

    # ------------------------------------------------------------ prefill

    def _chunk_plan(self, n_left: int) -> int:
        """Width of the next prefill piece: the first piece takes the
        remainder so every later piece is exactly ``prefill_chunk`` wide."""
        if self._chunk is None or n_left <= self._chunk:
            return n_left
        r = n_left % self._chunk
        return r if r else self._chunk

    def _advance_prefill(self):
        """Run ONE prefill chunk of the in-flight request; on completion
        sample its first token (unless resuming a preempted stream) and
        move it to the ready seat."""
        req = self._prefilling
        if req.cache is None:
            w = self._chunk_plan(len(req.prompt))
            logits, req.cache = self.engine.prefill_single(req.prompt[:w])
            req.n_done = w
            self.stats["prefills"] += 1
        else:
            w = self._chunk_plan(len(req.prompt) - req.n_done)
            piece = self._upload(req.prompt[None, req.n_done:req.n_done + w])
            with self.engine._scope():
                logits, req.cache = prefill_resume(self.params, piece,
                                                   self.cfg, req.cache)
            req.n_done += w
        self.stats["prefill_chunks"] += 1
        if req.n_done < len(req.prompt):
            return
        self._prefilling = None
        if req.gen_done:                      # preempt resume: no resample
            req.first_tok = self._emitted[req.rid][-1]
            self._ready = req
            return
        tok = int(host_sync(self.engine.sample(
            logits, np.asarray([req.rid]), np.zeros(1, np.int64)),
            reason="prefill admission: the first token decides "
            "retire-vs-admit before the slot splice")[0])
        self._emitted[req.rid] = []
        self._emit(req.rid, tok)
        if (self.scfg.eos_id >= 0 and tok == self.scfg.eos_id) \
                or req.budget <= 1:
            self.results[req.rid] = self._emitted.pop(req.rid)
            req.cache = None                  # retired at its first token
            return
        req.first_tok = tok
        self._ready = req

    # ---------------------------------------------------------- admission

    def _admit(self, req: _PagedReq, i: int) -> bool:
        need = kv.required_blocks(req.n_done, self.layout)
        ids = self.alloc.alloc(need)
        if ids is None:
            self.stats["deferred_admissions"] += 1
            return False
        row = kv.host_table_row(self.layout, ids)
        self.tables[i] = row
        self._row_blocks[i] = ids
        self._pos_host[i] = req.n_done
        if self._lo <= i < self._hi:
            with self.engine._scope():
                self.paged = kv.splice_request(
                    self.paged, req.cache, i - self._lo, self._upload(row),
                    self._local)
        req.cache = None
        n_gen = req.gen_done if req.gen_done else 1
        self.slots[i] = _PSlot(req, n_gen, req.first_tok)
        return True

    def _retire(self, i: int):
        s = self.slots[i]
        self.results[s.req.rid] = self._emitted.pop(s.req.rid)
        self._free_row(i)

    def _free_row(self, i: int):
        self.alloc.free(self._row_blocks[i])
        self._row_blocks[i] = []
        self.tables[i] = self.layout.sentinel
        self.slots[i] = None

    def _preempt(self, i: int):
        """Evict slot ``i`` by recompute: its prompt plus all but the last
        emitted token re-enter the prefill queue (the last emitted token
        is the next input, carried via ``gen_done``)."""
        s = self.slots[i]
        req = s.req
        gen = self._emitted[req.rid]
        req.prompt = np.concatenate(
            [req.prompt[:len(req.prompt) - max(req.gen_done - 1, 0)],
             np.asarray(gen[:-1], np.int32)]).astype(np.int32)
        req.gen_done = len(gen)
        req.n_done = 0
        req.cache = None
        req.first_tok = None
        self._free_row(i)
        heapq.heappush(self._pending, req)
        self.stats["preemptions"] += 1

    def _pick_victim(self) -> Optional[int]:
        live = [i for i, s in enumerate(self.slots) if s is not None]
        if not live:
            return None
        return max(live, key=lambda i: (self.slots[i].req.priority,
                                        self.slots[i].req.seq))

    def _ensure_blocks(self):
        """Grow every live row's table to cover its next decode block,
        preempting least urgent rows when the pool runs out.  Rows close
        to their budget reserve only what they can still write."""
        K = self.scfg.decode_block
        for i in range(self.n_slots):
            s = self.slots[i]
            if s is None:
                continue
            steps = min(K, s.req.budget - s.n_gen)
            need = kv.required_blocks(self._pos_host[i] + steps, self.layout)
            delta = need - len(self._row_blocks[i])
            if delta <= 0:
                continue
            ids = self.alloc.alloc(delta)
            while ids is None:
                v = self._pick_victim()
                self._preempt(v)
                if v == i:
                    break
                ids = self.alloc.alloc(delta)
            if self.slots[i] is None:
                continue                       # the row evicted itself
            k0 = len(self._row_blocks[i])
            self.tables[i, k0:k0 + delta] = ids
            self._row_blocks[i].extend(ids)

    # -------------------------------------------------------------- decode

    def _emit(self, rid, tok):
        self._emitted[rid].append(int(tok))
        self.stats["generated_tokens"] += 1
        if self._on_token is not None:
            self._on_token(rid, int(tok))

    def _run_block(self, tables, cur, rids, steps) -> torch.Tensor:
        """The K-step decode block on the device: gather the dense view,
        K decode steps with sampling (the tokens stay on the device),
        scatter the touched blocks.  Returns the [K, B] tokens; nothing in
        here synchronises with the host."""
        K = self.scfg.decode_block
        with self.engine._scope(), self.engine.local_rows(self._rows):
            dense = kv.gather_cache(self.paged, tables, self._local)
            start_pos = dense.pos
            tok, out = cur, []
            for t in range(K):
                logits, dense = decode_step(self.params, tok, dense, self.cfg)
                tok = self.engine.sample(logits, rids, steps + t)
                out.append(tok)
            self.paged = kv.scatter_decode(self.paged, dense, tables,
                                           self._local, start_pos, K)
            return torch.stack(out)

    def _decode_block(self):
        self._ensure_blocks()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return
        K = self.scfg.decode_block
        eos = self.scfg.eos_id
        cur = np.zeros(self.n_slots, np.int64)
        rids = np.zeros(self.n_slots, np.int64)
        steps = np.zeros(self.n_slots, np.int64)
        for i in active:
            s = self.slots[i]
            cur[i], rids[i], steps[i] = s.cur, s.req.rid, s.n_gen
        lo, hi = self._lo, self._hi
        toks = self.engine.gather_rows(self._run_block(
            self._upload(self.tables[lo:hi]), self._upload(cur[lo:hi]),
            rids[lo:hi], steps[lo:hi]), self._rows, dim=1)
        self.stats["decode_blocks"] += 1
        self.stats["decode_steps"] += K
        self.stats["slot_steps"] += K * len(active)
        toks = host_sync(toks, reason="the ONE per-block sync: K decode "
                         "steps' [K, B] tokens decide retirement and "
                         "admission together")
        for i in active:
            s = self.slots[i]
            self._pos_host[i] += K
            for t in range(K):
                tok = int(toks[t, i])
                s.cur = tok
                s.n_gen += 1
                self._emit(s.req.rid, tok)
                if (eos >= 0 and tok == eos) or s.n_gen >= s.req.budget:
                    self._retire(i)            # later writes hit sentinels
                    break

    # ---------------------------------------------------------------- run

    def run(self, on_token: Optional[Callable[[int, int], None]] = None,
            feed: Optional[Callable[[], bool]] = None
            ) -> dict[int, list[int]]:
        """Serve to completion; returns {rid: tokens} exactly like
        ``ContinuousBatcher.run`` (EOS inclusive, budget-truncated).
        ``feed`` injects wall-clock arrivals per iteration and keeps the
        loop polling while it returns True."""
        self._on_token = on_token
        feeding = feed is not None
        while True:
            if feeding:
                feeding = bool(feed())
            # admissions first: a freed slot refills before the next block
            while self._ready is not None:
                free = [i for i, s in enumerate(self.slots) if s is None]
                if not free or not self._admit(self._ready, free[0]):
                    break
                self._ready = None
            # one prefill chunk per iteration, only while the ready seat
            # is empty (bounded working-cache backlog, natural backpressure)
            if (self._prefilling is None and self._ready is None
                    and self._pending):
                self._prefilling = heapq.heappop(self._pending)
            if self._prefilling is not None:
                self._advance_prefill()
            if any(s is not None for s in self.slots):
                self._decode_block()
            elif (self._prefilling is None and self._ready is None
                  and not self._pending):
                if feeding:
                    time.sleep(5e-4)
                    continue
                break
        self._on_token = None
        san = _san_active()
        if san is not None:
            # every request retired and freed its table: the pool must be
            # whole again (leaks here = rows retired without free())
            san.audit_allocator(self.alloc, "PagedScheduler.run shutdown")
        return self.results
