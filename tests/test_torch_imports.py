"""The port stands alone: no module of ``hannoy_tpu_torch`` (nor the smoke
script that drives it on the GPU) imports JAX or the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "hannoy_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['hannoy_tpu'] = None; "
        "import hannoy_tpu_torch, hannoy_tpu_torch.build.builder, hannoy_tpu_torch.ops.beam, "
        "hannoy_tpu_torch.ops.beam_cuda, hannoy_tpu_torch.models.flat"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)


def _imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_no_jax_or_reference_imports_in_port():
    assert len(PORT_FILES) > 10
    offenders = {
        str(p.relative_to(REPO)): sorted(m for m in _imported_modules(p) if m.split(".")[0] in ("jax", "jaxlib", "hannoy_tpu"))
        for p in PORT_FILES
    }
    assert not any(offenders.values()), {k: v for k, v in offenders.items() if v}
