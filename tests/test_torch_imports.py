"""The port stands alone: no file of ``src/repro_torch``, ``src/ntx_torch``
or ``chip_smoke.py`` imports ``jax`` or anything of the JAX package
(``repro``/``ntx``), and importing every port module loads none of them.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro", "ntx"}
PORT_FILES = sorted([*(ROOT / "src" / "repro_torch").rglob("*.py"),
                     *(ROOT / "src" / "ntx_torch").rglob("*.py"),
                     ROOT / "chip_smoke.py"])


def _imported(tree: ast.AST):
    """Top-level module names a file imports, including string arguments
    of importlib.import_module / __import__ calls."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif isinstance(node, ast.Call):
            fn = node.func
            name = getattr(fn, "attr", None) or getattr(fn, "id", None)
            if name in ("import_module", "__import__") and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    yield arg.value
                elif isinstance(arg, ast.JoinedStr) and arg.values and \
                        isinstance(arg.values[0], ast.Constant):
                    yield str(arg.values[0].value)


def test_port_files_found():
    assert len(PORT_FILES) > 20
    assert ROOT / "chip_smoke.py" in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .replace(".__init__", "")
        for p in PORT_FILES if p.name != "chip_smoke.py")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without a CUDA device (or without the repository beside it) the
    script exits non-zero and prints no result line."""
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    for script in (ROOT / "chip_smoke.py",
                   tmp_path / "chip_smoke.py"):
        if script.parent == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], env=env,
                             capture_output=True, text=True, timeout=120,
                             cwd=script.parent)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
