"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``_build/`` (git-ignored), at first use, then loaded with ``ctypes``.
The library name carries a digest of the source and the flags, so an
edited source rebuilds and a stale library is never loaded. Builds
write to a temporary name and are renamed into place, so concurrent
processes cannot load a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from .backend import KernelError

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS = {}
_LOCK = threading.Lock()


def sources():
    """Names of every kernel source in ``csrc/``."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def nvcc():
    """The ``nvcc`` to use: ``$NVCC``, then ``PATH``, then the
    toolkit's default install under ``$CUDA_HOME`` (``/usr/local/cuda``)."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found: set $NVCC or $CUDA_HOME to build "
                       "the CUDA kernels")


def lib_path(name):
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name):
    """Start one ``nvcc`` for ``name`` unless its library exists;
    returns ``(process, tmp, final, log)`` or None."""
    final = lib_path(name)
    if os.path.exists(final):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{final}.{os.getpid()}.tmp"
    log = final[:-3] + ".log"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, final, log


def build(names=None):
    """Compile every named source (default: all), one ``nvcc`` each,
    all started together. Raises with the compiler output on failure.
    Returns ``{name: compiler output}`` for the sources built now."""
    names = sources() if names is None else list(names)
    jobs = {n: _start(n) for n in names}
    logs, failed = {}, []
    for name, job in jobs.items():
        if job is None:
            continue
        proc, tmp, final, log = job
        out, _ = proc.communicate()
        with open(log, "w") as f:
            f.write(out)
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            continue
        os.replace(tmp, final)
    if failed:
        raise KernelError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name):
    """The loaded ``ctypes`` library of kernel source ``name``, built
    on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            try:
                lib = ctypes.CDLL(lib_path(name))
            except OSError as e:
                raise KernelError(f"kernel library {name} did not load: "
                                  f"{e}") from e
            _LIBS[name] = lib
        return lib
