"""Build the port's CUDA kernels at first use.

Each ``koopmanx_torch/csrc/<name>.cu`` becomes
``koopmanx_torch/_build/lib<name>.so`` with a plain C interface that the
wrappers load with ``ctypes``. Nothing builds at import time; a library is
rebuilt when its source is newer. :func:`build_all` starts one ``nvcc``
per source, all together.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "from koopmanx_torch/csrc on a machine with the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    src = CSRC_DIR / f"{name}.cu"
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def _start(name: str) -> subprocess.Popen:
    out = library_path(name)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.kernel_name, proc.tmp_path = name, tmp
    return proc


def build_all(names: List[str] = None) -> Dict[str, str]:
    """Build every stale kernel library (all of ``csrc/*.cu`` by default)
    with one ``nvcc`` each, run together. Returns ``{name: nvcc output}``
    for the libraries built (the ``-Xptxas -v`` register and shared-memory
    report). Raises on a failed build."""
    if names is None:
        names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = [_start(n) for n in names if _stale(n)]
        reports, failed = {}, []
        for proc in procs:
            log, _ = proc.communicate()
            reports[proc.kernel_name] = log
            if proc.returncode != 0:
                failed.append(f"{proc.kernel_name}:\n{log}")
                proc.tmp_path.unlink(missing_ok=True)
            else:
                os.replace(proc.tmp_path, library_path(proc.kernel_name))
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return reports


def ensure_built(name: str) -> Path:
    if _stale(name):
        build_all([name])
    return library_path(name)
