"""Build and bind the CUDA kernels: ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``.

The library goes to ``build/repro_torch/`` at the root of the checkout,
named by a hash of its source and flags, and is built on first use (a few
seconds). Each ``nvcc`` run counts in the ``kernels.builds`` counter, the
probe that spans read to record a build as ``new_traces``. Nothing here
runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Sequence

from repro_torch import obs

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# IEEE expf/logf/log1pf and IEEE division: no --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# libraries compiled in this process; builds run on a thread pool, so the
# count is bumped under a lock
BUILDS = obs.counter("kernels.builds")
_BUILDS_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source,
    headers (``csrc/*.cuh``) and flags is already built; return the
    library's path. The compiler's report (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside it as ``.log``."""
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"{name}_{key.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        run = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                             capture_output=True, text=True)
        if run.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} "
                               f"(exit {run.returncode}):\n{run.stderr}")
        lib.with_suffix(".log").write_text(run.stdout + run.stderr)
        os.replace(tmp, lib)
        with _BUILDS_LOCK:
            BUILDS.inc()
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def build_libraries(names: Sequence[str]) -> List[Path]:
    """``build_library`` for each of ``names``, all ``nvcc`` processes
    started together; returns the libraries' paths in the same order."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return list(pool.map(build_library, names))


_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# the C signature of each library's launch function, `<name>_launch`; every
# library also exports `const char* <name>_error_string(int)`
LAUNCH_ARGTYPES = {
    # params_t, ts, out, B, n_steps, ut, inv_ut, stream
    "retention": [_P, _P, _P, _I64, _I, _F, _F, _P],
    # x, dt, A, Bc, Cc, D, y, h_final, states, B, S, di, n, stream
    "ssm_scan": [_P] * 9 + [_I] * 4 + [_P],
    # x, dt, A, Bc, Cc, D, states, dy, dh_final, dx, ddt, dA, dB, dC, dD,
    # scratch, scratch_floats, B, S, di, n, stream
    "ssm_scan_bwd": [_P] * 16 + [_I64] + [_I] * 4 + [_P],
    # q, k, v, o, lse, B, H, K, S, Sk, D, Dv, scale, bf16, causal, window,
    # sink, round_p, stream
    "flash_attention": [_P] * 5 + [_I] * 7 + [_F] + [_I] * 5 + [_P],
    # q, k, v, o, dO, lse, scratch, scratch_floats, dq, dk, dv, B, H, K, S,
    # Sk, D, Dv, scale, bf16, causal, window, sink, stream
    "flash_attention_bwd": [_P] * 7 + [_I64] + [_P] * 3 + [_I] * 7 + [_F]
    + [_I] * 4 + [_P],
}


# the C signature of `long long <name>_scratch_floats(...)`, the scratch a
# launch at a shape needs, in the libraries that take one: the launch checks
# its scratch against the same function
SCRATCH_ARGTYPES = {
    # B, S, di, n
    "ssm_scan_bwd": [_I] * 4,
    # B, H, K, S, Sk, D, Dv, bf16
    "flash_attention_bwd": [_I] * 8,
}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if needed, with the C
    signatures of its launch, error-string and (where it has one) scratch
    functions declared."""
    lib = ctypes.CDLL(str(build_library(name)))
    launch_fn = getattr(lib, f"{name}_launch")
    launch_fn.argtypes = LAUNCH_ARGTYPES[name]
    launch_fn.restype = ctypes.c_int
    if name in SCRATCH_ARGTYPES:
        scratch_fn = getattr(lib, f"{name}_scratch_floats")
        scratch_fn.argtypes = SCRATCH_ARGTYPES[name]
        scratch_fn.restype = ctypes.c_longlong
    error_string = getattr(lib, f"{name}_error_string")
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    return lib


def scratch_floats(name: str, *args) -> int:
    """``<name>_scratch_floats(*args)``: the float32 scratch the launch of
    ``name`` needs at that shape; raises where the library takes no such
    shape (0)."""
    floats = getattr(load(name), f"{name}_scratch_floats")(*args)
    if floats <= 0:
        raise ValueError(f"{name} takes no launch of shape {args}")
    return int(floats)


def launch(name: str, *args) -> None:
    """Call ``<name>_launch(*args)`` of the library ``name`` and raise if
    the launch was refused (``cudaGetLastError`` after the launch)."""
    lib = load(name)
    err = getattr(lib, f"{name}_launch")(*args)
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err} "
                           f"({msg})")
