"""Build and load the port's CUDA kernels.

At first use, every ``repro_torch/csrc/*.cu`` is compiled for ``sm_90a``
with ``nvcc`` — one ``nvcc -c`` per source, all started together — and the
objects are linked into one shared library with a plain C interface,
loaded with ``ctypes``. The library lands in ``build/repro_torch/<key>/``
at the repository root, keyed by a hash of the sources, the headers they
include (``csrc/*.cuh``) and the flags, so an edited file rebuilds and an
unchanged one is loaded as it is. A failed build raises; nothing falls
back to the plain PyTorch versions.

A ``FakeTensor`` (the dry run's, ``launch/dryrun.py``) never reaches a
launch: each wrapper checks ``fake`` before it, and ``charge`` hands the
call's cost to the active op counters (``launch/op_count.py``).
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
from torch._subclasses.fake_tensor import FakeTensor

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas -v: each kernel's registers, shared memory and spills, kept in
# the build directory's nvcc.log
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "librepro_torch_kernels.so"
LOG_NAME = "nvcc.log"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_count_lock = threading.Lock()


def count_launch(fn) -> None:
    """Add one to ``fn.launches``, a wrapper's count of its kernel's
    launches. Several threads launch at once (a fleet's workers, one a
    device), and a bare ``fn.launches += 1`` is a read and a write that a
    thread switch between them can lose an increment across; the lock
    makes the count exact. Callers read the count and set it to 0 as a
    plain attribute."""
    with _count_lock:
        fn.launches += 1


# the active op counters (launch/op_count.py), which fake calls charge
counters: list = []


def fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor, which no kernel launches on."""
    return isinstance(t, FakeTensor)


def takes_kernel(t: torch.Tensor, what: str) -> bool:
    """Whether a call on ``t`` goes to the kernel: a CUDA tensor, or a fake
    one on any device (the dry run counts the kernel); a CPU tensor takes
    the plain version. Raises on any other device."""
    if fake(t) or t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {t.device}")


def charge(fn, cost, out):
    """A fake call of ``fn``'s kernel: its ``cost`` ``(operations, bytes)``
    to each active op counter, ``fn.launches`` untouched; returns ``out``."""
    for c in counters:
        c.kernel(fn.__name__, *cost)
    return out


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
    for src in sorted(CSRC.glob("*.cu*")):
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
        logs = []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
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
        (out_dir / LOG_NAME).write_text("\n".join(logs))
        # atomic within the filesystem: a concurrent build of the same
        # key replaces an identical file
        os.replace(tmp_lib, lib_path)
    return lib_path


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.rmsnorm_fwd.argtypes = [
        p, p, p, p, ll, i, f,  # x, residual (or null), scale, out, rows, d, eps
        i, i,  # x and scale dtypes
        i, i, i,  # elements a vector, threads a row, vectors a thread
        i, p,  # device, stream
    ]
    lib.rmsnorm_fwd.restype = i
    lib.rmsnorm_bwd.argtypes = [
        p, p, p, p, p, p, ll, i, f,  # g, x, scale, dx, dscale, partials, rows, d, eps
        i, i,  # x and scale dtypes
        i, i, i, i, i,  # elements a vector, threads a row, vectors a thread, stages, blocks
        i, p,  # device, stream
    ]
    lib.rmsnorm_bwd.restype = i
    lib.flash_attention_fwd.argtypes = [
        p, p, p, p,  # q, k, v, o
        i, i, i, i, i, i,  # b, sq, sk, hq, hkv, d
        ll, ll, ll, ll, ll, ll, ll, ll, ll,  # q/k/v (batch, seq, head) strides
        f, i, i, i,  # scale, causal, window, q_offset
        i, p, p, i, p,  # dtype, tensor-map geometry (or null), lse (or null), device, stream
    ]
    lib.flash_attention_fwd.restype = i
    lib.flash_attention_bwd.argtypes = [
        p, p, p, p, p, p, p,  # q, k, v, o, dO, lse, D (scratch)
        p, p, p,  # dq, dk, dv
        i, i, i, i, i, i,  # b, sq, sk, hq, hkv, d
        f, i, i, i,  # scale, causal, window, q_offset
        i, p, p, i, i,  # dtype, tensor-map geometry, partials (or nulls), splits, paired
        i, p,  # device, stream
    ]
    lib.flash_attention_bwd.restype = i
    lib.wkv6_fwd.argtypes = [
        p, p, p, p, p, p, p, p,  # r, k, v, w, u, s0 (or null), o, state
        i, i, i, i, i, i,  # b, s, h, dk, dv, chunk
        ll, ll, ll, ll, ll, ll, ll, ll, ll, ll, ll, ll,  # r/k/v/w (batch, seq, head) strides
        i, p,  # device, stream
    ]
    lib.wkv6_fwd.restype = i
    lib.wkv6_fwd_tiled.argtypes = lib.wkv6_fwd.argtypes[:-2] + [
        i, i, p,  # state columns a block (0: the kernel's choice), device, stream
    ]
    lib.wkv6_fwd_tiled.restype = i
    lib.wkv6_bwd_workspace.argtypes = [i, i, i, i, i]  # b, s, h, dk, dv
    lib.wkv6_bwd_workspace.restype = ll
    # r, k, v, w, u, s0, do, dstate (the last three or null); dr, dk, dv,
    # dw, du, ds0 (or null), workspace; b, s, h, dk, dv; r/k/v/w (batch,
    # seq, head) strides; device, stream
    lib.wkv6_bwd.argtypes = [p] * 15 + [i] * 5 + [ll] * 12 + [i, p]
    lib.wkv6_bwd.restype = i


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call; later calls take no
    lock."""
    lib = _lib
    if lib is not None:
        return lib
    return _load()


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (> 0) or minus a
    driver ``CUresult`` (< 0, a tensor map that failed to encode)."""
    if err > 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
    if err < 0:
        raise RuntimeError(f"{what}: tensor-map encode failed, CUresult {-err}")


# the C entry points' dtype argument
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def current_stream(device_index: int) -> int:
    """The current stream's ``cudaStream_t`` on a device, as an int: what
    ``torch.cuda.current_stream(i).cuda_stream`` returns, without building
    a ``Stream`` object (several µs a launch on an H100 host; the
    ``host_us_a_call`` line of ``chip_smoke.py`` times both)."""
    return torch._C._cuda_getCurrentRawStream(device_index)
