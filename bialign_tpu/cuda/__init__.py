"""Build and registration of the CUDA wavefront kernel (``wavefront.cu``).

The kernel is compiled with ``nvcc`` for ``sm_90a`` into ``build/`` beside
this file (git-ignored) on first use, together with ``cases_gen.h``: the
recurrence's case structure written out from :mod:`bialign_tpu.ops.cases`,
so the C++ side holds no copy of it.  The library file name carries a hash
of everything that goes into it, so a changed source or case table never
loads a stale build.  ``python -m bialign_tpu.cuda`` builds it ahead of time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "wavefront.cu")
BUILD_DIR = os.path.join(_DIR, "build")
TARGET = "bialign_wavefront"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_registered = False


def _meta(col, src: int, mu1c: int, mu2c: int, klchk: int) -> int:
    """One case packed as the kernel decodes it: column bits 0-3, source
    state bits 4-7, mu1/mu2 multiplicity bits 8/9, k/l-guard bit 10."""
    return (col[0] | col[1] << 1 | col[2] << 2 | col[3] << 3 | src << 4
            | mu1c << 8 | mu2c << 9 | klchk << 10)


def case_header() -> str:
    """``cases_gen.h``: the affine and non-affine case tables in the
    kernel's packed form, in :mod:`~bialign_tpu.ops.cases` order.

    The k/l >= 0 guard is dropped only for the affine seq-only half
    columns (a, b, 0, 0), exactly as the XLA scan's group-C guard does,
    so the kernel's band agrees with the scan on every stored cell."""
    from ..ops.cases import (
        N_STATES,
        NONAFFINE_COLS,
        STATE_BOTH_MATCH,
        iter_affine_cases,
        nonaffine_case_multiplicities,
    )

    aff = []
    for q in range(N_STATES):
        for src, col, mu1c, mu2c, _g, _b, _d, _grp in iter_affine_cases(q):
            klchk = 0 if col[2] == 0 and col[3] == 0 else 1
            aff.append(_meta(col, src, mu1c, mu2c, klchk))
    na = []
    for col in NONAFFINE_COLS:
        mu1c, mu2c, _g, _d = nonaffine_case_multiplicities(col)
        na.append(_meta(col, 0, mu1c, mu2c, 1))
    nc = len(aff) // N_STATES

    def fn(name, vals):
        body = ", ".join(str(v) for v in vals)
        return (f"__host__ __device__ constexpr int {name}(int i) {{\n"
                f"  constexpr int t[{len(vals)}] = {{{body}}};\n"
                f"  return t[i];\n}}\n")

    return (
        "// Generated from bialign_tpu/ops/cases.py; do not edit.\n"
        "#pragma once\n"
        f"constexpr int AFF_NQ = {N_STATES};\n"
        f"constexpr int AFF_NC = {nc};\n"
        f"constexpr int AFF_BOTH_MATCH = {STATE_BOTH_MATCH};\n"
        f"constexpr int NA_NC = {len(na)};\n"
        + fn("aff_meta", aff) + fn("na_meta", na)
    )


def _nvcc() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    path = "/usr/local/cuda/bin/nvcc"
    return path if os.path.exists(path) else None


def build() -> str:
    """Compile the kernel library (idempotent); returns its path.

    Raises RuntimeError when no ``nvcc`` is found or compilation fails,
    with the compiler's output in the message."""
    import jax.ffi

    header = case_header()
    with open(_SRC, "rb") as fh:
        src = fh.read()
    key = hashlib.sha256(
        src + header.encode() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"lib{TARGET}_{key}.so")
    if os.path.exists(so):
        return so
    nvcc = _nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    gen_dir = os.path.join(BUILD_DIR, key)
    os.makedirs(gen_dir, exist_ok=True)
    with open(os.path.join(gen_dir, "cases_gen.h"), "w") as fh:
        fh.write(header)
    tmp = so + f".tmp{os.getpid()}"
    cmd = [nvcc, *NVCC_FLAGS, "-I", jax.ffi.include_dir(), "-I", gen_dir,
           "-o", tmp, _SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    with open(os.path.join(gen_dir, "ptxas.log"), "w") as fh:
        fh.write(proc.stderr)
    os.replace(tmp, so)
    return so


def register() -> None:
    """Build (if needed), load and register the FFI target for CUDA."""
    global _registered
    with _lock:
        if _registered:
            return
        import jax.ffi

        lib = ctypes.cdll.LoadLibrary(build())
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.BialignWavefront),
            platform="CUDA",
        )
        _registered = True


if __name__ == "__main__":
    print(build())
