"""The port stands alone: no module of ``hannoy_tpu_torch`` (nor the smoke
script that drives it on the GPU) imports JAX or the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "hannoy_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py",
    REPO / "examples" / "basic_torch.py",
]


def test_port_imports_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['hannoy_tpu'] = None; "
        "import hannoy_tpu_torch, hannoy_tpu_torch.build.builder, hannoy_tpu_torch.build.bulk, "
        "hannoy_tpu_torch.build.wave_ops, hannoy_tpu_torch.ops.beam, hannoy_tpu_torch.ops.beam_cuda, "
        "hannoy_tpu_torch.models.flat, hannoy_tpu_torch.utils.tracing, hannoy_tpu_torch.api, "
        "hannoy_tpu_torch.store, hannoy_tpu_torch.store.native_env, hannoy_tpu_torch.version, "
        "hannoy_tpu_torch.utils.idset; "
        "assert hannoy_tpu_torch.Database is hannoy_tpu_torch.api.Database"
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


def _attribute_chains(path: Path) -> set[str]:
    """Dotted names read anywhere in the file (``os.environ``, ``torch.cuda.is_available``)."""
    chains = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if parts and isinstance(node, ast.Name):
            chains.add(".".join([node.id, *reversed(parts)]))
    return chains


@pytest.mark.parametrize(
    "what, banned",
    [
        ("an environment variable", ("os.environ", "os.getenv", "os.environb", "os.putenv")),
        ("a probe for a CUDA device", ("torch.cuda.is_available", "torch.cuda.device_count")),
    ],
)
def test_port_reads_no_environment_and_probes_no_device(what, banned):
    """The caller chooses the device and the store backend: no port file
    reads the environment, and only the smoke script (which must refuse
    to run without a card) asks whether there is one."""
    files = [p for p in PORT_FILES if not (what.startswith("a probe") and p.name == "chip_smoke.py")]
    offenders = {
        str(p.relative_to(REPO)): sorted(c for c in _attribute_chains(p) if c.startswith(banned))
        for p in files
    }
    assert not any(offenders.values()), (what, {k: v for k, v in offenders.items() if v})
