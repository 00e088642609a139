"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with
a plain C interface, loaded with :mod:`ctypes`.  The build happens at first
use, into ``kernels/build/`` (listed in ``.gitignore``), under a name that
hashes the source, the shared ``csrc/*.cuh`` headers and the flags, so an
edited source never loads a stale library.  Builds write to a temporary
name and rename, so concurrent processes cannot load a half-written file.

Flags: ``sm_90a`` for Hopper; ``-fmad=false`` and no fast-math because the
sweep kernel must round exactly as the float32 reference does (a
contracted ``a*b + c`` feeding a ``floor`` changes a cycle count);
``-Xptxas=-v`` keeps the register and spill report in ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

_HERE = pathlib.Path(__file__).resolve().parent
SOURCE_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")

# C signatures of each library's entry points: name -> (restype, argtypes)
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "sweep_kernel": {
        "qappa_sweep_aggregates": (_I, [_P] * 16 + [_I] * 8 + [_P, _P]),
        "qappa_error_string": (ctypes.c_char_p, [_I]),
    },
    "w8a8_matmul": {
        "qappa_w8a8_matmul": (_I, [_P] * 5 + [_I] * 3
                              + [_P, ctypes.c_longlong] + [_I] * 3 + [_P]),
        "qappa_error_string": (ctypes.c_char_p, [_I]),
    },
    "w4a8_matmul": {
        "qappa_w4a8_matmul": (_I, [_P] * 5 + [_I] * 3
                              + [_P, ctypes.c_longlong] + [_I] * 3
                              + [_P, _P]),
        "qappa_error_string": (ctypes.c_char_p, [_I]),
    },
    "w8a8_decode": {
        "qappa_w8a8_decode": (_I, [_P] * 9 + [ctypes.c_longlong, _P,
                                               ctypes.c_longlong]
                              + [_I] * 8 + [_P, _P]),
        "qappa_error_string": (ctypes.c_char_p, [_I]),
    },
    "flash_attention": {
        "qappa_flash_attention": (_I, [_P] * 4 + [_I] * 6
                                  + [ctypes.c_float, _P]),
        "qappa_error_string": (ctypes.c_char_p, [_I]),
    },
    "flash_attention_tc": {
        "qappa_flash_attention_tc": (_I, [_P] * 4 + [_I] * 6
                                     + [ctypes.c_float, _P]),
        "qappa_error_string": (ctypes.c_char_p, [_I]),
    },
    **{name: {
        "qappa_flash_decode": (_I, [_P] * 5 + [_P, ctypes.c_longlong] * 2
                               + [_I] * 8 + [ctypes.c_float] + [_I] * 4
                               + [_P, _P]),
        "qappa_error_string": (ctypes.c_char_p, [_I]),
    } for name in ("flash_decode", "flash_decode_f32")},
    "fleet_sim": {
        "qappa_fleet_sim": (_I, [_P] * 7 + [_I] * 3
                            + [ctypes.c_longlong, _P, _P]),
        "qappa_error_string": (ctypes.c_char_p, [_I]),
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, or
    ``PATH``; raises when there is none."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels build on a "
            "host with the CUDA toolkit")
    return found


def library_path(name: str) -> pathlib.Path:
    src = b"".join(p.read_bytes() for p in [
        SOURCE_DIR / f"{name}.cu", *sorted(SOURCE_DIR.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start_build(name: str):
    """Start ``nvcc`` for one source unless its library exists; returns
    ``(process, tmp_path, final_path, log_file)`` or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    log = open(BUILD_DIR / f"{name}.log", "w")
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE_DIR / f"{name}.cu")],
        stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, out, log


def build_all(names=None) -> dict[str, pathlib.Path]:
    """Build every source (or ``names``) in parallel, one ``nvcc`` each;
    returns each library's path.  Raises with the compiler's output on a
    failed build."""
    names = list(names or sorted(p.stem for p in SOURCE_DIR.glob("*.cu")))
    started = {n: _start_build(n) for n in names}
    failed = []
    for name, job in started.items():
        if job is None:
            continue
        proc, tmp, out, log = job
        try:
            rc = proc.wait()
        finally:
            log.close()
        if rc != 0:
            tmp.unlink(missing_ok=True)
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        logs = "\n".join((BUILD_DIR / f"{n}.log").read_text() for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return {n: library_path(n) for n in names}


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``name`` ('' if none)."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LIBS[name] = lib
    return lib
