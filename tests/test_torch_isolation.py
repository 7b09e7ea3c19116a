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


def test_the_port_reads_a_reference_file_without_the_reference(tmp_path):
    """A file the reference wrote (bf16 included) loads in a process where
    ``paddle_tpu`` and ``jax`` cannot be imported at all; importing the
    whole namespace there builds no kernel."""
    import subprocess
    import sys

    import numpy as np

    import paddle_tpu as jpaddle

    path = tmp_path / "ref.pdparams"
    w = jpaddle.to_tensor(np.array([[1.5, -2.25], [3.0, 0.125]], np.float32))
    jpaddle.save({"w": w, "w16": w.astype("bfloat16"),
                  "ids": jpaddle.to_tensor(np.array([3, 1], np.int32)),
                  "meta": {"step": 4}}, str(path))
    code = f"""
import sys
sys.modules["paddle_tpu"] = None
sys.modules["jax"] = None
import paddle_tpu_torch as paddle
from paddle_tpu_torch.kernels import _build
paddle.set_device("cpu")
sd = paddle.load({str(path)!r})
assert sd["meta"] == {{"step": 4}}
assert sd["w16"].dtype == paddle.bfloat16
assert sd["w"].tolist() == [[1.5, -2.25], [3.0, 0.125]]
assert sd["w16"].float().tolist() == [[1.5, -2.25], [3.0, 0.125]]
assert sd["ids"].tolist() == [3, 1]
assert not _build._libs
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
            and sys.modules[m] is not None]
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
