"""Build the CUDA kernels of ``repro_torch/csrc`` and bind them with ctypes.

At first use, one ``nvcc`` per ``csrc/*.cu``, all started together,
compiles each source for ``sm_90a`` into an object, and one more links them
into one shared library with a plain C interface, under the repository's
``build/kernels/`` (listed in ``.gitignore``), named by a hash of the
sources and flags so an edit rebuilds and an unchanged tree reuses it.
Nothing here runs at import: the CPU tests import every module, and the
build is only reached when a wrapper is handed a CUDA tensor.

Each C entry point takes raw device pointers, sizes (``c_int``), scalars
(``c_float``) and the current CUDA stream as a ``c_void_p``, launches
without synchronising, and returns
``cudaGetLastError()``; :func:`check` raises if that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of every entry point (pointers and the stream as c_void_p, so
# ctypes never truncates them to 32 bits)
SIGNATURES = {
    "marvel_matmul_epilogue": (_P,) * 8 + (_I,) * 10 + (_P,),
    "marvel_fused_conv": (_P,) * 8 + (_I,) * 16 + (_P,),
    "marvel_windowed_pool": (_P, _P) + (_I,) * 16 + (_P,),
    "marvel_global_avgpool": (_P, _P) + (_I,) * 8 + (_P,),
    "marvel_depthwise_conv": (_P,) * 5 + (_I,) * 14 + (_P,),
    "marvel_sep_block": (_P,) * 10 + (_I,) * 19 + (_P,),
    "marvel_residual_rmsnorm": (_P,) * 5 + (_I, _I, _F) + (_I,) * 8 + (_P,),
    "marvel_flash_attention": (_P,) * 4 + (_I,) * 6 + (_F, _I, _I, _I, _P),
    "marvel_wkv_chunk": (_P,) * 10 + (_I,) * 5 + (_P,),
    "marvel_wkv_chunk_smem": (_I, _I),
    "marvel_mac_matmul_int8": (_P,) * 6 + (_I,) * 6 + (_P,),
    "marvel_wgmma_selftest": (_P, _P, _P, _I, _P),
    "marvel_imma_selftest": (_P, _P, _P, _I, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of this process's build


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from source at first "
            "use and need the CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmarvel_{h.hexdigest()[:16]}.so"


def _run(procs) -> None:
    """Wait for every (command, process); raise on the first failure."""
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile the library if no build of these sources exists: one nvcc
    per source in parallel, then the link."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        objs.append(obj)
    _run(procs)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
           *(str(o) for o in objs)]
    _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True))])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            loaded = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = loaded
        return _lib


def check(name: str, status: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")


def sm_count(device) -> int:
    """Streaming multiprocessors of the card (the split-K policy's input)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
