"""The port stands alone: no module of src/repro_torch, and not chip_smoke.py,
imports JAX, ml_dtypes or the JAX package, and importing the port leaves
none of them in sys.modules. No library attention or compiler is on its path, and the
kernel wrappers hold no try/except that could fall back."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
MODULES = sorted(PKG.rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_package_has_the_slice_modules():
    names = {str(p.relative_to(PKG)) for p in MODULES}
    assert {"configs/base.py", "models/params.py", "kernels/ops.py",
            "kernels/flash_attention.py", "kernels/decode_attention.py",
            "kernels/paged_decode_attention.py", "serving/engine.py",
            "serving/kv_pool.py", "serving/scheduler.py", "launch/serve.py",
            "steps.py", "device.py", "models/ssm.py", "kernels/gla_chunk.py",
            "configs/hymba_1_5b.py", "core/__init__.py", "core/descriptors.py",
            "core/vid.py", "core/legacy_vid.py", "core/faults.py", "core/callspec.py",
            "core/interpose.py", "core/drain.py", "core/ckpt_io.py",
            "core/ckpt_pipeline.py", "core/ckpt.py", "core/restore.py",
            "core/coordinator.py", "core/runtime_state.py"} <= names
    assert {f"core/backends/{n}.py" for n in (
        "__init__", "base", "fabric", "mpich", "craympi", "openmpi", "exampi",
        "fabricdirect")} <= names
    assert {p.name for p in (PKG / "csrc").iterdir()} >= {
        "flash_attention.cu", "decode_attention.cu", "paged_decode_attention.cu",
        "decode_split.cuh", "gla_chunk.cu"}


@pytest.mark.parametrize("path", MODULES + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_module_imports_no_jax_and_no_repro(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    mods = ["repro_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
            for p in MODULES if p.name != "__init__.py"]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            + repr(FORBIDDEN) + ")\n"
            + "assert not bad, bad\nprint('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_library_attention_on_the_path():
    for path in MODULES:
        text = path.read_text()
        for word in ("scaled_dot_product_attention", "torch.compile", "cudnn",
                     "flash_attn"):
            assert word not in text, f"{path} mentions {word}"


@pytest.mark.parametrize("name", ["ops.py", "flash_attention.py",
                                  "decode_attention.py", "paged_decode_attention.py",
                                  "gla_chunk.py"])
def test_kernel_wrappers_have_no_fallback(name):
    tree = ast.parse((PKG / "kernels" / name).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
