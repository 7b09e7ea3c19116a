"""The port stands alone: no module of paddle_tpu_torch/, and not
chip_smoke.py, imports jax or anything of paddle_tpu (an AST scan of
every import statement, relative imports resolved)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    pkg = path.relative_to(ROOT).with_suffix("").parts[:-1]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = list(pkg[:len(pkg) - node.level + 1])
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module or ""
            yield mod
            for alias in node.names:
                yield f"{mod}.{alias.name}"


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu")


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert path.exists(), path
    bad = sorted({m for m in _imported_modules(path) if _forbidden(m)})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_relative_imports():
    mods = set(_imported_modules(
        ROOT / "paddle_tpu_torch" / "models" / "gpt.py"))
    assert "paddle_tpu_torch.kernels.mlp_fusion" in mods
    assert not any(_forbidden(m) for m in mods)


def test_scan_walks_every_subpackage():
    """The scan covers each subpackage of the port, vision/ included."""
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for sub in ("kernels", "models", "nn", "optimizer", "vision"):
        assert any(n.startswith(f"paddle_tpu_torch/{sub}/") for n in names)
    assert "paddle_tpu_torch/vision/models/resnet.py" in names
