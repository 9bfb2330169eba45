"""The port's examples (``repro_torch.examples.{quickstart,serve_lm,
train_lm}``) on the CPU at reduced size, against the reference's
``examples/``.

* quickstart prints the reference's numbers line for line (the same
  numpy operands; only the package's name and the kernel backend's name,
  ``kernel`` for ``pallas``, differ);
* ``hundred_m_config`` equals the reference's for every arch;
* serve_lm serves every request of its queue and train_lm trains its
  steps on ``kernel`` (the plain version on the CPU), with the
  reference's flags and ``--device cpu``, each on its arch's reduced
  config in place of ``hundred_m_config``.
"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs import ALL_ARCHS
from repro_torch.configs import get_config as tget
from repro_torch.examples import quickstart, serve_lm, train_lm

ROOT = Path(__file__).resolve().parents[1]


def _reference_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_prints_the_reference_numbers(capsys):
    _reference_example("quickstart").main()
    ref = capsys.readouterr().out.splitlines()
    quickstart.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(ref) == 14
    for a, b in zip(got, ref):
        if "backends registered" in b:
            assert a.replace("kernel", "pallas").split(": ")[1] == \
                str(sorted(eval(b.split(": ")[1])))
            continue
        assert a.replace("repro_torch", "repro") == b


def test_hundred_m_config_equals_reference():
    ref = _reference_example("train_lm")
    for arch in ALL_ARCHS:
        a, b = train_lm.hundred_m_config(arch), ref.hundred_m_config(arch)
        shared = {f.name for f in dataclasses.fields(a)} \
            & {f.name for f in dataclasses.fields(b)} - {"policy"}
        assert {k: getattr(a, k) for k in shared} == \
            {k: getattr(b, k) for k in shared}, arch


def _reduced(name):
    return tget(name).reduced()


def test_serve_lm_serves_its_queue(monkeypatch, capsys):
    monkeypatch.setattr(serve_lm, "hundred_m_config", _reduced)
    results = serve_lm.main(["--arch", "olmo-1b", "--requests", "3",
                             "--new-tokens", "4", "--slots", "2",
                             "--device", "cpu"])
    out = capsys.readouterr().out
    assert sorted(results) == [0, 1, 2]
    assert all(1 <= len(v) <= 4 for v in results.values())
    assert "slot-level batching: 3 requests" in out
    assert "incl. compile" not in out


def test_train_lm_trains_on_the_kernel(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(train_lm, "hundred_m_config", _reduced)
    history = train_lm.main(["--steps", "3", "--seq", "16", "--batch", "2",
                             "--accel", "kernel", "--ckpt-dir",
                             str(tmp_path / "ckpt"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert [h["step"] for h in history] == [0, 1, 2]
    assert all(math.isfinite(h["loss"]) for h in history)
    assert "accel=kernel device=cpu" in out
    # the checkpoint resumes: a second run has no step left
    assert train_lm.main(["--steps", "3", "--seq", "16", "--batch", "2",
                          "--accel", "kernel", "--ckpt-dir",
                          str(tmp_path / "ckpt"), "--device", "cpu"]) == []
