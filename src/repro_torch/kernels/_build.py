"""Build the port's CUDA kernels into one shared library, at first use.

Every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` (one ``nvcc -c``
per source, all started together), and the objects link into one ``.so``
with a plain C interface that ``ctypes`` loads: no PyTorch headers, so the
build takes seconds. The library lands in ``kernels/_build/`` under a name
keyed by the sources' and flags' digest, so an edited source never meets a
stale library. Nothing here runs at import time: the first CUDA launch
calls ``load()``.

No ``--use_fast_math``: the kernels' epilogue comparisons and the IEEE
float32 arithmetic the host/device byte parity rests on need it off.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()
build_seconds: float | None = None  # wall time of this process's build
build_log: str = ""                 # nvcc's output (ptxas register report)


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + COMPILE_FLAGS).encode())
    for p in sorted(SRC_DIR.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = []
    failed = None
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        logs.append(f"$ {' '.join(c)}\n{out}")
        if p.returncode != 0 and failed is None:
            failed = (c, out)
    if failed is not None:
        raise RuntimeError(f"nvcc failed: {' '.join(failed[0])}\n{failed[1]}")
    return "\n".join(logs)


def build(target: Path) -> None:
    """Compile every source in parallel and link them into ``target``."""
    global build_seconds, build_log
    t0 = time.perf_counter()
    sources = sorted(SRC_DIR.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, s.stem + ".o") for s in sources]
        log = _run_all([[nvcc(), *ARCH_FLAGS, *COMPILE_FLAGS, "-c", str(s),
                         "-o", o] for s, o in zip(sources, objs)])
        so_tmp = os.path.join(tmp, target.name)
        log += "\n" + _run_all([[nvcc(), *ARCH_FLAGS, "-shared", *objs,
                                 "-o", so_tmp]])
        os.replace(so_tmp, target)  # atomic: a reader never sees half a .so
    build_seconds = time.perf_counter() - t0
    build_log = log


def load() -> ctypes.CDLL:
    """The kernels' library, built on first call in this checkout."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = BUILD_DIR / f"libdiskjoin_kernels_{_digest()}.so"
        if not target.exists():
            build(target)
        lib = ctypes.CDLL(str(target))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.pairwise_l2_threshold_launch.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, i32, ctypes.c_float, i32, ptr]
        lib.pairwise_l2_threshold_launch.restype = i32
        lib.pairwise_l2_sm90_launch.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, i32, ctypes.c_float, i32, ptr,
            i32, ptr]
        lib.pairwise_l2_sm90_launch.restype = i32
        lib.bucket_assign_launch.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
        lib.bucket_assign_launch.restype = i32
        lib.bucket_assign_sm90_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr, i32, ptr]
        lib.bucket_assign_sm90_launch.restype = i32
        strides = ctypes.POINTER(ctypes.c_longlong)
        shape = [i32] * 9  # B, Sq, T, H, Hkv, D, causal, window, q_offset
        lib.flash_simt_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, strides, *shape, ctypes.c_float,
            i32, i32, ptr]
        lib.flash_simt_launch.restype = i32
        lib.flash_prefill_sm90_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, strides, *shape, ctypes.c_float,
            i32, ptr]
        lib.flash_prefill_sm90_launch.restype = i32
        lib.flash_prefill_sm90_f32_launch.argtypes = \
            lib.flash_prefill_sm90_launch.argtypes
        lib.flash_prefill_sm90_f32_launch.restype = i32
        lib.flash_decode_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, strides, *shape, ctypes.c_float,
            i32, i32, i32, ptr, ptr, ptr, i32, i32, ptr]
        lib.flash_decode_launch.restype = i32
        lib.flash_decode_merge_launch.argtypes = [
            ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, ptr]
        lib.flash_decode_merge_launch.restype = i32
        lib.flash_bwd_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, strides, *shape,
            ctypes.c_float, i32, ptr, ptr, i32, ptr]
        lib.flash_bwd_launch.restype = i32
        lib.flash_bwd_sm90_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, strides, *shape,
            ctypes.c_float, i32, ptr, ptr, ptr, ptr, i32, ptr]
        lib.flash_bwd_sm90_launch.restype = i32
        lib.flash_bwd_sm90_f32_launch.argtypes = \
            lib.flash_bwd_sm90_launch.argtypes
        lib.flash_bwd_sm90_f32_launch.restype = i32
        _lib = lib
        return lib
