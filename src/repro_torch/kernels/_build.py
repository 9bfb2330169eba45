"""Build a kernel source with ``nvcc`` into a library for ``ctypes``.

Each ``csrc/*.cu`` file holds one kernel behind a plain C launcher.
:func:`build` compiles it for Hopper (``sm_90a``) into ``build/`` at the
repo root, once per source content, and returns the library's path for
``ctypes.CDLL``.  The compile runs on first use, never at import.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def build(source: Path) -> Path:
    """Compile ``source`` into ``build/<stem>_<content hash>.so`` (once
    per source content) and return that path.  Raises when ``nvcc`` is
    missing or the compile fails; the compiler's output is kept beside
    the library as ``.log``."""
    source = Path(source)
    digest = hashlib.sha1(source.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"{source.stem}_{digest}.so"
    if out.exists():
        return out
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found: the CUDA toolkit is needed to "
                           f"build {source.name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"({res.returncode}):\n{res.stderr}")
    (BUILD_DIR / f"{out.stem}.log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)           # atomic: concurrent builders are safe
    return out

