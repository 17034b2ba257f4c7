"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source ``ops/csrc/<name>.cu`` has a plain C interface and compiles,
on first use, into ``build/dtf_tpu_torch/<name>-<hash>.so`` under the
repository root (the directory is git-ignored). The hash covers the
source, the shared headers ``csrc/*.cuh`` and the flags, so an edited
kernel or header is rebuilt and a stale library is never loaded. Nothing here runs at import time: the CPU tests import
every module of the package on a machine with no ``nvcc``.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
        -Xcompiler -fPIC -o build/dtf_tpu_torch/<name>-<hash>.so csrc/<name>.cu
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "dtf_tpu_torch")

#: Every kernel source of the package, by name (``csrc/<name>.cu``).
KERNELS = ("flash_fwd", "flash_bwd", "fused_ce", "embed_gather")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit PyTorch itself found. Raises if there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        candidates.append(shutil.which("nvcc"))
    try:
        from torch.utils.cpp_extension import CUDA_HOME
    except ImportError:
        CUDA_HOME = None
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from ops/csrc at first use")


def library_path(name: str) -> str:
    """Where kernel ``name`` is built: the hash covers ``<name>.cu``, every
    header ``csrc/*.cuh`` (name and text, in sorted order) and the flags."""
    digest = hashlib.sha256()
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for path in (os.path.join(CSRC_DIR, f"{name}.cu"), *headers):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str, extra_flags: tuple[str, ...]):
    """Start one nvcc for ``name`` (or return None if it is built)."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names=KERNELS, *, ptxas_verbose: bool = False) -> dict[str, str]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns ``{name: compiler output}``;
    with ``ptxas_verbose``, ``-Xptxas -v`` adds each kernel's registers,
    shared memory and spills (it changes no code, so it is not hashed).
    Raises with the compiler's output on failure. The library is written
    under a temporary name and renamed into place, so concurrent processes
    never load a half-written file."""
    extra = ("-Xptxas", "-v") if ptxas_verbose else ()
    started = {n: _start(n, extra) for n in names}
    logs, errors = {}, []
    for n, job in started.items():
        if job is None:
            logs[n] = ""
            continue
        proc, tmp, out = job
        text, _ = proc.communicate()
        logs[n] = text
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (rc {proc.returncode}):\n"
                          f"{text}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib
