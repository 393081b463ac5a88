"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` compiles on first use, with one ``nvcc`` process per
source all started together, into a shared library with a plain C entry
point under ``build/kernels/`` at the repository root, named by a hash of
the source and the flags, so an edited source rebuilds and an unchanged one
is loaded as is.  The library is loaded with ``ctypes``: pointers and the
stream are passed as ``c_void_p``.

Nothing here runs at import time: the CPU tests import every module of the
port on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"

#: ``-fmad=false`` keeps ``a + b * c`` as two roundings, as the plain
#: PyTorch versions compute it (a kernel that wants the fused product
#: writes ``fmaf``); expf/logf stay the accurate library calls.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: C entry point and argument types of every kernel library
ENTRY_POINTS = {
    "calib_mape": ("calib_mape_grid_launch", [_P] * 7 + [_I] * 6 + [_P]),
    "des_readout": ("des_readout_launch", [_P] * 2),
    "power_sim": ("power_sim_launch", [_P] * 2 + [_I] * 3 + [_F] * 5 + [_P]),
    "flash_attention": ("flash_attention_launch",
                        [_P] * 5 + [_I] * 9 + [_F] + [_P]),
    "ssd_chunk": ("ssd_chunk_launch", [_P] * 8 + [_I] * 6 + [_P]),
    "des_place": ("des_place_launch", [_P] * 2),
}

#: further C functions of a kernel library, each returning an int: the
#: limits a wrapper checks shapes against, stated once in the source, and
#: des_place's barrier and decision-step probes (their CUDA error codes)
QUERIES = {
    "ssd_chunk": {"ssd_chunk_max_p": [], "ssd_chunk_max_q": [_I]},
    "des_place": {"des_place_max_hosts": [],
                  "des_place_barrier_launch": [_I, _I, _P, _P],
                  "des_place_step_launch": [_I, _P, _P]},
}

#: ptxas report (registers, shared memory, spills) of each build
BUILD_LOG: dict[str, str] = {}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> pathlib.Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=tuple(ENTRY_POINTS)) -> dict[str, pathlib.Path]:
    """Compile every named kernel that is not built yet, in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, building it on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build((name,))[name]
            lib = ctypes.CDLL(str(path))
            fn_name, argtypes = ENTRY_POINTS[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            for q_name, q_args in QUERIES.get(name, {}).items():
                q_fn = getattr(lib, q_name)
                q_fn.argtypes = q_args
                q_fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib
