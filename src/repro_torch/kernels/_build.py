"""Build and load the port's CUDA kernels.

At first use, every ``repro_torch/csrc/*.cu`` is compiled for ``sm_90a``
with ``nvcc`` — one ``nvcc -c`` per source, all started together — and the
objects are linked into one shared library with a plain C interface,
loaded with ``ctypes``. The library lands in ``build/repro_torch/<key>/``
at the repository root, keyed by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one is loaded as it is. A failed
build raises; nothing falls back to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
LIB_NAME = "librepro_torch_kernels.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the CUDA
    toolkit's default install location."""
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        return str(Path(cuda_home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_key() -> str:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS + CFLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (if this key is not built yet); return the
    library's path. Raises ``RuntimeError`` with nvcc's output on failure."""
    out_dir = BUILD_ROOT / build_key()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        procs = []
        objs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
            objs.append(str(obj))
        failures = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{src.name}:\n{out}")
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        out_dir.mkdir(parents=True, exist_ok=True)
        # atomic within the filesystem: a concurrent build of the same
        # key replaces an identical file
        os.replace(tmp_lib, lib_path)
    return lib_path


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.rmsnorm_fwd.argtypes = [p, p, p, p, ll, i, f, i, i, i, p]
    lib.rmsnorm_fwd.restype = i
    lib.flash_attention_fwd.argtypes = [
        p, p, p, p,  # q, k, v, o
        i, i, i, i, i, i,  # b, sq, sk, hq, hkv, d
        ll, ll, ll, ll, ll, ll, ll, ll, ll,  # q/k/v (batch, seq, head) strides
        f, i, i, i,  # scale, causal, window, q_offset
        i, i, p,  # dtype, device, stream
    ]
    lib.flash_attention_fwd.restype = i


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


# the C entry points' dtype argument
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
