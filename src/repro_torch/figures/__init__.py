"""The paper's figure checks in the port, one module per figure: each
``run(device)`` prints ``name,us_per_call,derived`` CSV rows and asserts
the paper's claim, as the reference's ``benchmarks/fig*.py`` do.
``python -m repro_torch.figures.run`` runs them all."""
