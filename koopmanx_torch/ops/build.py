"""Build the port's CUDA kernels at first use.

Each ``koopmanx_torch/csrc/<name>.cu`` becomes
``koopmanx_torch/_build/lib<name>.so`` with a plain C interface that the
wrappers load with ``ctypes``; a source built with preprocessor
``defines`` (one width of ``dare_terminal.cu``, one shape of
``qp_build.cu``) becomes one library for
each set of them, ``lib<name>_<key><value>.so``; such a source names the
defines it needs in :data:`REQUIRED_DEFINES`, and is built only with
them. Nothing builds at import time; a library is rebuilt when its source
is newer. :func:`build_all` starts one ``nvcc`` per source, all together.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

# sources built only with these defines (one library a width), and so
# left out of build_all's default list
REQUIRED_DEFINES = {"dare_terminal": ("KX_DARE_NZ",),
                    "qp_build": ("KX_QPB_NZ", "KX_QPB_M", "KX_QPB_PY",
                                 "KX_QPB_N")}

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


def library_path(name: str, defines: Optional[Dict[str, int]] = None
                 ) -> Path:
    tag = "".join(f"_{k.lower()}{v}" for k, v in sorted((defines or {}).items()))
    return BUILD_DIR / f"lib{name}{tag}.so"


def _stale(name: str, defines: Optional[Dict[str, int]] = None) -> bool:
    lib = library_path(name, defines)
    src = CSRC_DIR / f"{name}.cu"
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def _start(name: str, defines: Optional[Dict[str, int]] = None
           ) -> subprocess.Popen:
    out = library_path(name, defines)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    flags = [f"-D{k}={v}" for k, v in sorted((defines or {}).items())]
    cmd = [nvcc_path(), *NVCC_FLAGS, *flags, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.kernel_name, proc.tmp_path, proc.out_path = name, tmp, out
    return proc


def build_all(names: List[str] = None,
              defines: Optional[Dict[str, int]] = None) -> Dict[str, str]:
    """Build every stale kernel library (by default every ``csrc/*.cu``
    but those of :data:`REQUIRED_DEFINES`), each with ``defines``, with
    one ``nvcc`` each, run together. Returns ``{name: nvcc output}`` for
    the libraries built (the ``-Xptxas -v`` register and shared-memory
    report). Raises on a failed build, or where a source lacks a define
    it needs."""
    if names is None:
        names = sorted(p.stem for p in CSRC_DIR.glob("*.cu")
                       if p.stem not in REQUIRED_DEFINES)
    for name in names:
        missing = [k for k in REQUIRED_DEFINES.get(name, ())
                   if k not in (defines or {})]
        if missing:
            raise ValueError(f"{name}.cu is built with {missing} defined")
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = [_start(n, defines) for n in names if _stale(n, defines)]
        reports, failed = {}, []
        for proc in procs:
            log, _ = proc.communicate()
            reports[proc.kernel_name] = log
            if proc.returncode != 0:
                failed.append(f"{proc.kernel_name}:\n{log}")
                proc.tmp_path.unlink(missing_ok=True)
            else:
                os.replace(proc.tmp_path, proc.out_path)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return reports


def ensure_built(name: str, defines: Optional[Dict[str, int]] = None
                 ) -> Path:
    if _stale(name, defines):
        build_all([name], defines)
    return library_path(name, defines)
