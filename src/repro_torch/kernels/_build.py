"""Build the port's CUDA kernels with ``nvcc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` functions that return
their ``cudaError_t``; it is compiled on first use into
``lib<name>-<hash>.so`` under :func:`build_dir` (by default
``build/repro_torch/`` at the root of the checkout, a directory
``.gitignore`` lists), keyed by a hash of the source and the flags, so an
edited source rebuilds and an unchanged one is reused.  The
compiler's ``-Xptxas -v`` report (registers, shared memory, spills) is
kept beside the library (:func:`build_log`).

``build`` starts one ``nvcc`` per missing library, all at once; the first
use of any kernel builds every source of :data:`SOURCES` that is missing,
in parallel.  A missing ``nvcc`` or a failed compile raises
``RuntimeError``: nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_CHECKOUT = Path(__file__).resolve().parents[3]
BUILD_DIR_ENV = "REPRO_TORCH_BUILD_DIR"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: every ``csrc/<name>.cu`` the port builds
SOURCES = ("probe_arena", "sweep_grid", "icws_hash", "minhash_sketch")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [str(Path(cuda_home) / "bin" / "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels cannot be built")


def build_dir() -> Path:
    """Where the libraries go: ``$REPRO_TORCH_BUILD_DIR`` when set, else
    ``build/repro_torch/`` at the root of the checkout the package runs
    from.  A copy installed outside a checkout needs the variable, so that
    nothing is written next to site-packages."""
    env = os.environ.get(BUILD_DIR_ENV)
    if env:
        return Path(env)
    if not ((_CHECKOUT / "pyproject.toml").is_file()
            and (_CHECKOUT / "src" / "repro_torch" / "csrc").is_dir()):
        raise RuntimeError(f"repro_torch is not running from a checkout "
                           f"({_CHECKOUT}): set {BUILD_DIR_ENV} to the "
                           "directory the CUDA kernels are built in")
    return _CHECKOUT / "build" / "repro_torch"


def lib_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` lives once built."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return build_dir() / f"lib{name}-{digest}.so"


def build_log(name: str) -> str:
    """The compiler's report for ``name`` (empty if it was never built)."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names) -> None:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together."""
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return
    nvcc = _nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = lib_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``; the first use builds it
    together with every other missing source of :data:`SOURCES`."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build(dict.fromkeys((name, *SOURCES)))
            lib = ctypes.CDLL(str(lib_path(name)))
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a launcher returned a nonzero ``cudaError_t``."""
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: error {code} "
                           f"({msg})")
