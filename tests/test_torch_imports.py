"""Import hygiene of the port: ``repro_torch`` imports neither ``jax`` nor
the JAX package ``repro``, so it installs on a GPU host without JAX.
Checked twice: by importing every module in a fresh interpreter, and by
reading every import statement of its sources, of ``chip_smoke.py``, of
``examples/paper_repro_torch.py`` and of the pure-Python
``benchmarks/paper_figures.py`` that the example prints from."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PKG = SRC / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py"))
# the serving, reducer and hierarchical slices' modules, which the checks below must reach
SERVING = (
    "repro_torch.configs.qwen3_1_7b",
    "repro_torch.configs.rwkv6_7b",
    "repro_torch.core.compression",
    "repro_torch.core.hierarchical",
    "repro_torch.kernels.collectives.kernel",
    "repro_torch.kernels.collectives.ops",
    "repro_torch.kernels._build",
    "repro_torch.kernels.flash_attention.kernel",
    "repro_torch.kernels.flash_attention.ops",
    "repro_torch.kernels.flash_attention.ref",
    "repro_torch.kernels.quantize",
    "repro_torch.kernels.quantize.kernel",
    "repro_torch.kernels.quantize.ops",
    "repro_torch.kernels.quantize.ref",
    "repro_torch.kernels.rwkv6.kernel",
    "repro_torch.kernels.rwkv6.ops",
    "repro_torch.kernels.rwkv6.ref",
    "repro_torch.launch.serve",
    "repro_torch.models.attention",
    "repro_torch.models.common",
    "repro_torch.models.rwkv",
    "repro_torch.models.transformer",
    "repro_torch.obs.metrics",
    "repro_torch.runtime.kvcache",
    "repro_torch.runtime.serve_loop",
)


def _module_name(path: Path) -> str:
    parts = path.relative_to(SRC).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


def test_importing_every_module_loads_no_jax_or_repro():
    modules = [_module_name(p) for p in SOURCES]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(bad)); print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.splitlines()[0] == "0", res.stdout


def test_serving_modules_are_checked():
    assert set(SERVING) <= {_module_name(p) for p in SOURCES}


@pytest.mark.parametrize("path", SOURCES + [ROOT / "chip_smoke.py",
                                            ROOT / "tests" / "test_torch_cuda.py",
                                            ROOT / "examples" / "paper_repro_torch.py",
                                            ROOT / "benchmarks" / "paper_figures.py"],
                         ids=lambda p: (str(p.relative_to(PKG))
                                        if PKG in p.parents else p.name))
def test_source_imports_no_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"
