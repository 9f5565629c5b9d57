"""Builds the package's CUDA kernels at first use and loads them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds); the sources compile in parallel, one ``nvcc`` each.
Libraries land in ``build/bayesian_yolov3_torch/`` under the repository
root, named by a hash of their source, of every shared header
(``csrc/*.cuh``) and of the compiler flags, so an unchanged source is
built once per checkout and an edited header rebuilds its users.

Importing this module needs neither ``nvcc`` nor a card; only
``load(...)`` does.  A build or load failure raises — no caller falls back
to a plain PyTorch version on a CUDA tensor.

``load_host(name)`` does the same for a host-only helper, ``csrc/<name>.c``,
with the host C compiler (``$CC``, else ``cc``): the PNG loader's row
unfilter.  It needs no CUDA toolkit, so the CPU tests build and run it too;
a failed build raises with the compiler's message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

CC_FLAGS = ["-O2", "-shared", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # compiler output of this process's builds, by kernel


def build_dir() -> str:
    return os.path.join(os.path.dirname(_PKG_DIR), "build", "bayesian_yolov3_torch")


def kernel_names() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of bayesian_yolov3_torch are "
            "built from csrc/*.cu at first use and need the CUDA toolkit"
        )
    return exe


def _target(name: str, source: str = None, flags=NVCC_FLAGS) -> str:
    if source is None:
        headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
        sources = [name + ".cu", *headers]
    else:
        sources = [source]
    h = hashlib.sha256(" ".join(flags).encode())
    for fname in sources:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read() + b"\0")
    return os.path.join(build_dir(), f"lib{name}_{h.hexdigest()[:16]}.so")


def build_all(verbose: bool = False, names=None, defines=()) -> Dict[str, str]:
    """Compile every kernel source (or those in ``names``) that has no
    library yet, all ``nvcc`` processes started together; ``defines`` adds
    ``-D`` flags (a measurement build, named apart by the flags' hash).
    Returns {kernel name: library path}."""
    flags = NVCC_FLAGS + [f"-D{d}" for d in defines]
    with _lock:
        os.makedirs(build_dir(), exist_ok=True)
        targets = {name: _target(name, flags=flags) for name in names or kernel_names()}
        procs = []
        for name, out in targets.items():
            if os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *flags]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            cmd += ["-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        errors = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{log}")
                continue
            build_logs[name] = log
            os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
        if errors:
            raise RuntimeError("\n".join(errors))
        return targets


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed (with
    ``defines``: that build alone)."""
    key = "+".join((name, *defines))
    lib = _libs.get(key)
    if lib is None:
        path = (build_all(names=[name], defines=defines) if defines else build_all())[name]
        with _lock:
            lib = _libs.setdefault(key, ctypes.CDLL(path))
    return lib


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of the host-only ``csrc/<name>.c``, compiled by the
    host C compiler at first use (into the same build directory, named by
    a hash of the source and flags)."""
    key = "host:" + name
    lib = _libs.get(key)
    if lib is not None:
        return lib
    with _lock:
        out = _target(name, name + ".c", CC_FLAGS)
        if not os.path.exists(out):
            os.makedirs(build_dir(), exist_ok=True)
            cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
            if not cc:
                raise RuntimeError(f"no C compiler (cc) to build csrc/{name}.c")
            tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
            proc = subprocess.run([cc, *CC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".c")],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{cc} failed for csrc/{name}.c:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
        lib = _libs.setdefault(key, ctypes.CDLL(out))
    return lib
