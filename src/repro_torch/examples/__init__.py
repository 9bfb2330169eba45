"""The reference's examples on the port: ``python -m
repro_torch.examples.<name>`` for ``quickstart`` (the paper's BP/BS MVM
in five sections), ``serve_lm`` (batched generate and slot-level
continuous batching) and ``train_lm`` (the fault-tolerant trainer on a
~100M-parameter LM).  Each takes the reference's flags and ``--device``
(default ``cuda``).  The CIFAR QAT example is
:mod:`repro_torch.train.cifar_qat`."""
