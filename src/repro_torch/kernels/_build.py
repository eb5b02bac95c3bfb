"""Build and bind the port's CUDA kernels (csrc/*.cu) at first use.

Each source is compiled by ``nvcc`` for Hopper into its own shared library
with a plain C interface and loaded with ``ctypes`` — no PyTorch headers,
so a build takes seconds, not minutes.  Libraries go to a git-ignored
build directory (``build/repro_torch_kernels`` at the repository root, or
``$REPRO_TORCH_BUILD_DIR``), named by a digest of the sources and flags so
a changed source is never served a stale library.  ``build_all`` starts
one ``nvcc`` per source, all together.

Every pointer and the stream cross as ``c_void_p`` (a bare Python int
would be cut to 32 bits); each C entry returns ``cudaGetLastError()``
right after its launch and ``check`` raises on anything but 0.  Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from repro_torch.configs.runtime import ENV_BUILD_DIR, env_str

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {"tcn_block": "tcn_block.cu", "proto_extract": "proto_extract.cu",
           "log2_matmul": "log2_matmul.cu", "dilated_conv": "dilated_conv.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# nvcc's stderr per library (ptxas: registers, shared memory, spills)
build_log: dict[str, str] = {}


def build_dir() -> Path:
    d = env_str(ENV_BUILD_DIR)
    if d:
        return Path(d)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    home = env_str("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, Path]:
    """Compile every library in ``names`` (default: all) that is not built
    yet, one nvcc process per source, started together.  Raises with the
    compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    out = {n: _target(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for n in todo:
        tmp = out[n].with_name(f"{out[n].name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[n])]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, tmp, p in procs:
        log, _ = p.communicate()
        build_log[n] = log
        if p.returncode != 0:
            failed.append(f"nvcc failed for {SOURCES[n]} "
                          f"(exit {p.returncode}):\n{log}")
        else:
            os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed.  ``signatures``
    maps each C entry to its argtypes; every entry returns a C int.  A
    library already loaded is returned without taking the lock."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, fn: str, rc: int) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{fn}: CUDA error {rc} ({msg})")
