"""Build and load the port's CUDA kernels.

One shared library holds all the kernels: the semiring SpMV and fused
superstep of the graph engine, the flash (prefill and training forward)
and decode attention of the LM serving path, and the flash backward of
LM training.  At first use, ``nvcc`` compiles every
``csrc/*.cu`` into one object each (all compiles started together), links
them into the library with a plain C interface, and the library is loaded
with ``ctypes``.  The build
lands in ``kernels/build/<hash>/``, keyed by the sources and flags, so an
edited source rebuilds and an unchanged one loads at once.  Nothing is
built when this module is imported.

Flags: ``-gencode arch=compute_90a,code=sm_90a`` (Hopper), ``-O3``, and no
``--use_fast_math``, which would change NaN/inf semantics and flush
denormals.  Every C entry point returns ``cudaGetLastError()`` after its
launch; :func:`check` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
CSRC = HERE / "csrc"
BUILD = HERE / "build"
LIB_NAME = "librepro_torch_kernels.so"
# semiring and walk arguments of the graph kernels' C entry points
SEMIRING_CODES = {"min_plus": 0, "plus_mul": 1}
WALK_CODES = {"one_lane": 0, "groups_of_4": 0, "groups_of_8": 0,
              "lane_walk": 1}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-Xcompiler", "-fPIC",
)

_lib: Optional[ctypes.CDLL] = None
#: seconds the last build took in this process (0.0 when it loaded a
#: library built earlier), and what ``nvcc``/``ptxas`` printed
build_seconds = 0.0
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "from source on the machine with the card")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _build(out_dir: Path, cu_files, verbose: bool) -> Path:
    """Compile each source in parallel, then link.  Returns the library."""
    global build_log
    nvcc = _nvcc()
    tmp = out_dir.with_name(f"{out_dir.name}.tmp{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)
    ptxas = ("-Xptxas", "-v") if verbose else ()
    procs = []
    for cu in cu_files:
        obj = tmp / (cu.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *ptxas, "-c", str(cu), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    failed = []
    for cmd, _, proc in procs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    lib = tmp / LIB_NAME
    cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(lib),
           *(str(o) for _, o, _ in procs)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n$ {' '.join(cmd)}\n"
                           f"{res.stdout}")
    log.append(res.stdout)
    build_log = "".join(log)
    try:
        os.replace(tmp, out_dir)  # atomic: a concurrent build may win
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)
    return out_dir / LIB_NAME


def library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    cu_files, headers = _sources()
    out_dir = BUILD / _digest(cu_files + headers)
    so = out_dir / LIB_NAME
    t0 = time.perf_counter()
    if not so.exists():
        so = _build(out_dir, cu_files, verbose)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.spmv_blocked_f32.argtypes = [vp] * 9 + [i32] * 6 + [i64] * 2 + [
        i32, i32, i32, vp]
    lib.spmv_blocked_f32.restype = i32
    lib.fused_step_f32.argtypes = [vp] * 13 + [i32] * 6 + [i64] * 2 + [
        i32, i32, i32, vp]
    lib.fused_step_f32.restype = i32
    f32 = ctypes.c_float
    lib.flash_attention_fwd.argtypes = [vp, vp, vp, vp, vp, *[i32] * 6,
                                        *[i64] * 8, i32, i32, i32, f32, i32,
                                        ctypes.POINTER(i32), vp]
    lib.flash_attention_fwd.restype = i32
    lib.flash_attention_bwd.argtypes = [vp] * 10 + [i32] * 9 + [
        f32, i32, ctypes.POINTER(i32), vp]
    lib.flash_attention_bwd.restype = i32
    lib.flash_attention_bwd_scratch.argtypes = [i32] * 3
    lib.flash_attention_bwd_scratch.restype = i64
    lib.decode_attention_fwd.argtypes = [vp] * 7 + [i32] * 5 + [i64] * 6 + [
        i32, i32, f32, i32, ctypes.POINTER(i32), vp]
    lib.decode_attention_fwd.restype = i32
    lib.cuda_error_string.argtypes = [i32]
    lib.cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg}) at launch")
