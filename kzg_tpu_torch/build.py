"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process, for
sm_90a, into ``build/kernels/lib<name>-<hash>.so`` at the repository root
(listed in .gitignore) and loaded with ctypes: a plain C interface, no
PyTorch headers, so a build takes seconds. The hash covers the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing is built at import: the first kernel call builds what it needs,
and `build_all` starts every build at once.

`host_library` builds the host pairing library from native/pairing.cpp
with g++ and the flags of native/Makefile, into build/native/ (the port
never loads or writes native/'s own build).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "..", "build", "kernels")
SOURCES = ("fr_kernels", "fr_route_kernels", "g1_kernels", "g1_fft_kernels",
           "g1_table_kernels", "g1_point_kernels", "g1_sum_kernels",
           "pairing_kernels", "exp_field_kernels", "exp_point_kernels")
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of every C entry point, by library
SIGNATURES = {
    "fr_kernels": {
        "kzg_mont_mul": (_I, _P, _P, _P, _I, _I, _P),
        "kzg_butterfly": (_I, _P, _P, _P, _P, _P, _I, _I, _P),
        "kzg_fr_butterfly_stage": (_P, _P, _I, _I, _I, _I, _I, _P),
        "kzg_fr_dif_stage": (_P, _P, _I, _I, _I, _I, _P),
        "kzg_fr_signed_windows": (_P, _P, _I, _P),
    },
    "fr_route_kernels": {
        "kzg_fr_add_sub": (_I, _I, _P, _P, _P, _I, _I, _P),
        "kzg_fr_pow": (_I, _P, _P, _I, _P, _I, _P),
        "kzg_fr_batch_inv": (_P, _P, _I, _I, _I, _P, _I, _P, _I, _P),
        "kzg_fr_fft_block": (_P, _P, _P) + (_I,) * 6 + (_P, _P),
        "kzg_fr_das_block": (_P,) * 5 + (_I,) * 6 + (_P, _P),
        "kzg_fr_zero_poly_leaves": (_P, _P, _P, _I, _P),
    },
    "g1_kernels": {
        "kzg_g1_scalar_mul": (_P,) * 7 + (_I, _I, _P),
        "kzg_g1_glv_butterfly": (_P,) * 14 + (_I, _I, _P),
    },
    "g1_fft_kernels": {
        "kzg_g1_fft_stage": (_P,) * 6 + (_I,) * 5 + (_P,),
    },
    "g1_table_kernels": {
        "kzg_g1_window_table": (_P,) * 5 + (_I, _I, _I, _P),
        "kzg_g1_fixed_base_mul": (_P,) * 5 + (_I, _I, _P),
    },
    "g1_point_kernels": {
        "kzg_g1_add": (_P,) * 9 + (_I, _P),
        "kzg_g1_double": (_P,) * 6 + (_I, _P),
    },
    "g1_sum_kernels": {
        "kzg_g1_sum": (_P,) * 6 + (_I,) * 4 + (_P,),
        "kzg_g1_horner": (_P,) * 6 + (_I, _P),
    },
    "pairing_kernels": {
        "kzg_g2_scalar_mul": (_P,) * 7 + (_I, _I, _P),
        "kzg_pairing_lines": (_P,) * 3 + (_I, _P),
        "kzg_pairing_miller_eval": (_P,) * 11 + (_I, _I, _P),
        "kzg_pairing_final_exp": (_P,) * 4 + (_I, _P),
    },
    "exp_field_kernels": {
        "kzg_exp_mont_chain": (_I, _I) + (_P,) * 5 + (_I, _I, _P),
        "kzg_exp_tc_mont_mul": (_I,) + (_P,) * 5 + (_I, _P),
        "kzg_exp_op_chain": (_I, _P, _P, _I, _I, _P),
        "kzg_exp_tuple_chain": (_I, _I, _P, _P, _I, _I, _P),
        "kzg_exp_ext_chain": (_I, _I) + (_P,) * 6 + (_I, _I, _P),
        "kzg_exp_ext_body": (_I,) + (_P,) * 7 + (_I, _I, _P),
    },
    "exp_point_kernels": {
        "kzg_exp_point_chain": (_I, _I, _I) + (_P,) * 6 + (_I, _I, _P),
    },
}
ROOT = os.path.dirname(os.path.dirname(CSRC))
NATIVE_SOURCE = os.path.join(ROOT, "native", "pairing.cpp")
HOST_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda, "bin", "nvcc")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(os.path.abspath(BUILD_DIR),
                        f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source unless its library is built; returns
    (process or None, library path, log path)."""
    path = _lib_path(name)
    log = path[:-3] + ".log"
    if os.path.exists(path):
        return None, path, log
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [_nvcc(), *FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")],
            stdout=f, stderr=subprocess.STDOUT)
    return (proc, tmp), path, log


def _finish(started, path: str, log: str) -> None:
    if started is None:
        return
    proc, tmp = started
    if proc.wait() != 0:
        with open(log) as f:
            raise RuntimeError(f"nvcc failed for {path}:\n{f.read()}")
    os.replace(tmp, path)


def build_all() -> dict:
    """Build every kernel library in parallel (one nvcc per source).
    Returns {name: nvcc log text} for the libraries built now."""
    with _lock:
        jobs = {n: _start(n) for n in SOURCES}
        logs = {}
        for n, (started, path, log) in jobs.items():
            _finish(started, path, log)
            if started is not None:
                with open(log) as f:
                    logs[n] = f.read()
        return logs


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    with _lock:
        started, path, log = _start(name)
        _finish(started, path, log)
    lib = ctypes.CDLL(path)
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def host_library() -> ctypes.CDLL:
    """The host pairing library, built from native/pairing.cpp into
    build/native/libkzgpair-<hash>.so at first use; raises if g++ fails."""
    with open(NATIVE_SOURCE, "rb") as f:
        h = hashlib.sha256(" ".join(HOST_FLAGS).encode() + f.read())
    path = os.path.join(ROOT, "build", "native",
                        f"libkzgpair-{h.hexdigest()[:16]}.so")
    with _lock:
        if not os.path.exists(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            out = subprocess.run(["g++", *HOST_FLAGS, "-o", tmp, NATIVE_SOURCE],
                                 capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError(f"g++ failed for {NATIVE_SOURCE}:\n"
                                   f"{out.stdout}{out.stderr}")
            os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    lib.kzg_pairings_verify.restype = ctypes.c_int
    lib.kzg_pairings_verify.argtypes = (ctypes.c_char_p, ctypes.c_int) * 4
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
