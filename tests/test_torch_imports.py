"""The port stands alone: no file of ``src/repro_torch/`` and not
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``, and
``import repro_torch`` works in an interpreter where both are blocked."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_repro(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_port_imports_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import repro_torch, repro_torch.accel, repro_torch.configs\n"
        "import repro_torch.kernels.cima_mvm, repro_torch.models\n"
        "import repro_torch.kernels.flash_attention, repro_torch.kernels.ops\n"
        "import repro_torch.serve, repro_torch.convert\n"
        "import repro_torch.core.energy, repro_torch.core.sqnr\n"
        "import repro_torch.core.sparsity, repro_torch.optim.qat\n"
        "import repro_torch.configs.cifar_nets, repro_torch.models.cnn\n"
        "import repro_torch.tree, repro_torch.data.pipeline\n"
        "import repro_torch.optim.adamw, repro_torch.optim.compression\n"
        "import repro_torch.train.state, repro_torch.train.step\n"
        "import repro_torch.train.checkpoint, repro_torch.train.trainer\n"
        "import repro_torch.train.cifar_qat, repro_torch.figures.run\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
