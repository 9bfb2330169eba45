"""Paper Fig. 11: QAT-train the paper's CIFAR networks and evaluate them
under the chip model, the ideal bit-true integer model and float.  The
port's counterpart of the reference's ``examples/train_cifar_qat.py``
(its noiseless part).

Every managed projection's forward runs on the net's policy backend (the
CUDA kernel, ``kernel``), its backward is the straight-through float32
GEMM; AdamW updates the weights and BN parameters, and the running BN
statistics the inference datapath folds are updated outside the
gradient.  CIFAR-10 itself is not in the repository: a structured
synthetic class-template set stands in, so the printed accuracies are no
CIFAR-10 accuracies.

Run:  PYTHONPATH=src python -m repro_torch.train.cifar_qat [--net a|b]
      [--steps 60] [--batch 64] [--full] [--device cuda]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.cifar_nets import NETWORK_A, NETWORK_B, CnnConfig
from repro_torch.core import energy as E
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models.cnn import (cnn_forward, cnn_loss, init_cnn,
                                    update_bn_stats)
from repro_torch.optim.adamw import (AdamWConfig, OptState, apply_updates,
                                     init_opt_state)

from .step import value_and_grad


def qat_update(params, opt: OptState, batch: dict, net: CnnConfig,
               opt_cfg: AdamWConfig):
    """One QAT step: loss and gradients of ``cnn_loss`` (train mode),
    AdamW, then the running BN statistics from this batch.  Returns
    ``(params, opt, metrics)``; metrics are 0-dim device tensors
    (``loss``, ``acc``, ``grad_norm``, ``lr``)."""
    (_, m), grads = value_and_grad(lambda p: cnn_loss(p, batch, net), params)
    params, opt, om = apply_updates(params, grads, opt, opt_cfg)
    params = update_bn_stats(params, m.pop("bn_stats"))
    return params, opt, {**m, **om}


@torch.no_grad()
def fig11_accuracy(params, batches, net: CnnConfig, backend: str) -> float:
    """Mean accuracy over ``batches`` in inference mode (running BN
    statistics folded into the fused datapath epilogue) under
    ``backend``."""
    accs = []
    for b in batches:
        logits = cnn_forward(params, b["images"], net, backend=backend)
        accs.append(float(torch.mean(
            (torch.argmax(logits, -1) == b["labels"]).to(torch.float32))))
    return sum(accs) / len(accs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", default="a", choices=["a", "b"])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    net = NETWORK_A if args.net == "a" else NETWORK_B
    if not args.full:
        net = net.reduced()
    data_cfg = DataConfig(kind="cifar_synthetic", global_batch=args.batch,
                          seed=1)
    params = init_cnn(0, net, device=args.device)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=args.steps,
                          weight_decay=0.0)
    opt = init_opt_state(params)

    print(f"training {net.name} ({'full' if args.full else 'reduced'}) "
          f"with CIMU QAT (B_A={net.ba}, B_X={net.bx}, {net.readout}) "
          f"on {args.device}")
    t0 = time.time()
    for step in range(args.steps):
        batch = make_batch(data_cfg, step, args.device)
        params, opt, m = qat_update(params, opt, batch, net, opt_cfg)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"  step {step:4d} loss={float(m['loss']):.3f} "
                  f"acc={float(m['acc']):.3f} ({time.time()-t0:.0f}s)")

    eval_batches = [make_batch(data_cfg, 10_000 + i, args.device)
                    for i in range(5)]
    chip_backend = net.policy.default.backend
    acc_chip = fig11_accuracy(params, eval_batches, net, chip_backend)
    acc_ideal = fig11_accuracy(params, eval_batches, net, "digital_int")
    acc_float = fig11_accuracy(params, eval_batches, net, "digital")
    print(f"\naccuracy (synthetic data): chip-model ({chip_backend})="
          f"{acc_chip:.3f}  ideal-int={acc_ideal:.3f}  float={acc_float:.3f}")
    print("paper claim: chip ~= ideal "
          f"(A: 92.4 vs 92.7, B: 89.3 vs 89.8) -> gap here: "
          f"{abs(acc_chip - acc_ideal):.3f}")
    cost = (E.network_cost(E.NETWORK_A, 4, 4, vdd=0.85, sparsity=0.5)
            if args.net == "a" else
            E.network_cost(E.NETWORK_B, 1, 1, vdd=0.85, sparsity=0.0,
                           readout="abn", overhead_cycles=149500))
    print(f"chip cost for the full topology (65 nm model): "
          f"{cost['energy_uj']:.1f} uJ/image @ {cost['fps']:.0f} fps "
          f"(paper: {'105.2uJ/23fps' if args.net == 'a' else '5.31uJ/176fps'})")


if __name__ == "__main__":
    main()
