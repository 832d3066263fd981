"""Build the port's CUDA kernels and load them with ``ctypes``.

Every ``csrc/*.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). The
libraries go to ``build/tinygp_tpu_torch/<digest>/`` beside the package,
keyed by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one is reused. All sources compile in parallel, one ``nvcc``
each, with ``-Xptxas -v``: each library's compiler output (every kernel's
registers, shared memory and spills) is kept beside it and read back by
:func:`build_log`. A failed build raises; nothing falls back.
"""

from __future__ import annotations

__all__ = ["build_all", "build_log", "library"]

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "tinygp_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the port's CUDA kernels "
        "are built from source at first use"
    )


def _out_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh", ".h"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` that is not built yet; return the paths
    of all the libraries, by source stem."""
    out = _out_dir()
    out.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: out / f"lib{src.stem}.so" for src in CSRC.glob("*.cu")}
    todo = {stem: path for stem, path in libs.items() if not path.exists()}
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = {}
    for stem, path in todo.items():
        # Build to a private name, then rename: concurrent builders of the
        # same digest never see a half-written library.
        fd, tmp = tempfile.mkstemp(dir=out, suffix=".so")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{stem}.cu")]
        procs[stem] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
        )
    failures = []
    for stem, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode == 0:
            libs[stem].with_suffix(".log").write_text(log)
            os.replace(tmp, libs[stem])
        else:
            os.unlink(tmp)
            failures.append(f"{stem}.cu (nvcc exit {proc.returncode}):\n{log}")
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return libs


def build_log(stem: str) -> str:
    """The compiler's output for ``csrc/<stem>.cu`` (built if needed)."""
    return build_all()[stem].with_suffix(".log").read_text()


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``, built if needed."""
    with _LOCK:
        if stem not in _LIBS:
            _LIBS[stem] = ctypes.CDLL(str(build_all()[stem]))
        return _LIBS[stem]
