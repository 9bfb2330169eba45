"""Serving example: batched prefill + decode with continuous batching.
Port of the reference's ``examples/serve_lm.py``.

Builds a small LM (random weights from a seed), then serves a queue of
variable-length prompts through the slot-based continuous batcher.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm
      [--arch llama3.2-1b] [--requests 6] [--new-tokens 24]
      [--device cuda]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.examples.train_lm import hundred_m_config
from repro_torch.models import init_params
from repro_torch.serve.engine import ContinuousBatcher, Engine, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = hundred_m_config(args.arch)
    params = init_params(cfg, 0, device=args.device, max_seq=512)
    scfg = ServeConfig(max_seq=256, max_new_tokens=args.new_tokens,
                       temperature=args.temperature)

    # --- single batched generate
    eng = Engine(params, cfg, scfg, device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.slots, 16)).astype(np.int32)
    t0 = time.time()
    gen = eng.generate(prompts)
    dt = time.time() - t0
    print(f"batched generate: {gen.shape[0]}x{gen.shape[1]} tokens "
          f"in {dt:.1f}s ({gen.size / dt:.0f} tok/s, first call)")
    t0 = time.time()
    gen = eng.generate(prompts)
    dt = time.time() - t0
    print(f"warm: {gen.size/dt:.0f} tok/s")

    # --- slot-level continuous batching over a ragged request queue:
    # ragged prompt lengths AND ragged per-request token budgets; finished
    # slots are re-prefilled alone (pad-masked) and spliced back in while
    # the other slots keep decoding
    cb = ContinuousBatcher(params, cfg, scfg, n_slots=args.slots,
                           device=args.device)
    rids = [cb.submit(rng.integers(0, cfg.vocab,
                                   (int(rng.integers(4, 32)),)
                                   ).astype(np.int32),
                      max_new_tokens=int(rng.integers(4, args.new_tokens + 1)))
            for _ in range(args.requests)]
    first_token_at = {}
    t0 = time.time()
    results = cb.run(on_token=lambda rid, tok: first_token_at.setdefault(
        rid, time.time() - t0))
    dt = time.time() - t0
    total = sum(len(v) for v in results.values())
    st = cb.stats
    util = st["slot_steps"] / max(st["decode_steps"] * args.slots, 1)
    print(f"slot-level batching: {len(rids)} requests, {total} tokens "
          f"in {dt:.1f}s — {st['decode_steps']} decode steps, "
          f"{st['prefills']} prefills, slot utilization {util:.0%}")
    for rid in rids[:3]:
        print(f"  req {rid}: first token at {first_token_at[rid]:.2f}s, "
              f"{results[rid][:8]}...")
    return results


if __name__ == "__main__":
    main()
