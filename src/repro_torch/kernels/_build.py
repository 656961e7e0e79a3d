"""``nvcc`` build and cache shared by the port's hand-written CUDA kernels.

Each kernel family compiles its own ``csrc/`` sources for ``sm_90a`` into
a shared library with a plain C interface, at first use, in
``build/repro_torch/`` under the repository root.  The library is named
by the family and a hash of its sources and the flags, so a changed
source rebuilds and an unchanged one loads at once.  Nothing here runs
when the module is imported; a missing compiler or a failed build raises.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def build_dir() -> Path:
    """``build/repro_torch/`` under the repository root."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the "
            "CUDA kernels cannot be built")
    return found


def build(name: str, sources: Sequence[Path]) -> Path:
    """Compile ``sources`` into ``lib<name>-<hash>.so`` unless that
    library exists; return its path.  Concurrent callers each compile to
    their own temporary file and rename it into place."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(Path(s).read_bytes())
    out = build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {res.returncode}:\n"
            f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out
