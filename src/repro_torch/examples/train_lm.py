"""End-to-end driver: train a ~100M-parameter LM for a few hundred steps
through the full stack — config system, synthetic data pipeline with
double-buffered prefetch, fault-tolerant trainer (async checkpoints,
auto-resume), AdamW, optional BP/BS gradient compression and
in-memory-computing matmuls via a ``repro_torch.accel`` backend.  Port
of the reference's ``examples/train_lm.py``.

The trainer resumes from the newest checkpoint in ``--ckpt-dir`` (and
then runs only the steps left): pass a fresh directory for a fresh run.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200
      [--arch olmo-1b] [--accel kernel] [--compress-bits 8]
      [--device cuda]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compression import CompressionConfig
from repro_torch.train.trainer import TrainerConfig, train


def hundred_m_config(name: str):
    """Shrink an assigned arch to ~100M params, keeping its family."""
    cfg = get_config(name)
    return dataclasses.replace(
        cfg, n_layers=min(cfg.n_layers, 8), d_model=512,
        n_heads=8, n_kv_heads=min(cfg.n_kv_heads, 8) or 0, head_dim=64,
        d_ff=2048, vocab=32768,
        moe_d_ff=512 if cfg.moe else 0,
        n_experts=min(cfg.n_experts, 8), experts_per_tok=min(
            cfg.experts_per_tok, 2),
        kv_lora_rank=128 if cfg.mla else 0,
        qk_nope_head_dim=64 if cfg.mla else 0,
        qk_rope_head_dim=32 if cfg.mla else 0,
        v_head_dim=64 if cfg.mla else 0,
        lru_width=512 if cfg.lru_width else 0,
        ssm_state=64 if cfg.ssm_state else 0,
        attn_window=min(cfg.attn_window, 256) if cfg.attn_window else None,
        frontend_seq=min(cfg.frontend_seq, 16) if cfg.frontend_seq else 0,
        enc_layers=min(cfg.enc_layers, 2),
        dtype="float32", remat=False,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accel", default="",
                    help="accel backend for every static-weight matmul "
                         "(bpbs | digital_int | kernel; empty = digital)")
    ap.add_argument("--compress-bits", type=int, default=0,
                    help="BP/BS gradient compression (0 = off)")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = hundred_m_config(args.arch)
    if args.accel:
        cfg = cfg.with_accel(backend=args.accel, ba=4, bx=4)

    from repro_torch.models.counting import param_count
    print(f"arch={cfg.name} family={cfg.family} "
          f"params~{param_count(cfg)/1e6:.0f}M "
          f"accel={cfg.policy.default.backend} device={args.device}")

    data_cfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                          vocab=cfg.vocab, seed=0,
                          frontend_seq=cfg.frontend_seq,
                          d_model=cfg.d_model)
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    comp = (CompressionConfig(bits=args.compress_bits)
            if args.compress_bits else None)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=50, log_every=10)
    state, history = train(cfg, data_cfg, opt_cfg, tcfg, comp_cfg=comp,
                           device=args.device)
    first = sum(h["loss"] for h in history[:5]) / max(len(history[:5]), 1)
    last = sum(h["loss"] for h in history[-5:]) / max(len(history[-5:]), 1)
    print(f"\nloss: {first:.3f} -> {last:.3f} over {len(history)} steps "
          f"({'improved' if last < first else 'NOT improved'})")
    return history


if __name__ == "__main__":
    main()
