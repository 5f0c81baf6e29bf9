"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file is compiled in one nvcc call into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds). The library goes into ``madrona_learn_tpu_torch/_build/<hash>/``,
keyed by a hash of the sources and flags, so a checkout builds once and any
edit to a source rebuilds. Nothing is built or loaded at import time: the
first kernel launch calls :func:`library`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libmlt_kernels.so"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # Per-kernel registers, shared memory and spills, kept in build.log.
    "--resource-usage",
)


@dataclass
class Kernel:
    """One hand-written kernel: what it replaces and how often it ran.

    ``launches`` is incremented by the kernel's wrapper where, and only
    where, it launches the kernel on the card.
    """

    name: str
    source: str
    replaces: str
    launches: int = 0


def find_nvcc() -> str:
    """nvcc from ``CUDA_HOME``, then ``PATH``, then ``/usr/local/cuda``."""
    candidates = []
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        candidates.append(Path(cuda_home) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file() and os.access(path, os.X_OK):
            return str(path)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin); the CUDA kernels of madrona_learn_tpu_torch "
        "need the CUDA toolkit to build")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def build() -> Path:
    """Compile the kernels if this exact source set was not built yet."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = BUILD_DIR / digest.hexdigest()[:16]
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path

    out_dir.mkdir(parents=True, exist_ok=True)
    tmp_path = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp_path),
           *(str(s) for s in _sources() if s.suffix == ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp_path, lib_path)
    return lib_path


def build_log() -> str:
    """The compiler output of the current build (resource usage)."""
    return (build().parent / "build.log").read_text()


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_SIGNATURES = {
    # rewards, values, dones, bootstrap, advantages, T, N, gamma,
    # gamma * lambda, stream
    "mlt_gae": [_P, _P, _P, _P, _P, _I, _I, _F, _F, _P],
    # dtype, H, xp, keep, wr, bias, c0, h0, ys, cs, T, N, stream
    "mlt_lstm_fwd": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    # dtype, H, xp, keep, wr, wr_t, bias, c0, h0, ys, cs, dys, dxp, dh0,
    # dc0, part_w, part_b, dwr, db, T, N, splits, stream
    "mlt_lstm_bwd": [_I, _I] + [_P] * 17 + [_I, _I, _I, _P],
    # dtype, D, q, k, v, out, B, S, H, valid_len, scale, stream
    "mlt_mha_fwd": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # dtype, H, layers, F, N, x, (w, ln_scale, ln_bias) x 4, wi, wr, bias,
    # c, h, feats, c_out, h_out, stream
    "mlt_policy_step": [_I] * 5 + [_P] * 21 + [_P],
    # dtype, H, F, x, keep, wi, wr, bias, c0, h0, ys, cs, T, N, stream
    "mlt_lstm_proj_fwd": [_I, _I, _I] + [_P] * 9 + [_I, _I, _P],
    # dtype, H, F, x, keep, wi, wi_t, wr, wr_t, bias, c0, h0, ys, cs, dys,
    # dx, dg, dh0, dc0, part_wi, part_w, part_b, dwi, dwr, db, T, N,
    # splits, stream
    "mlt_lstm_proj_bwd": [_I, _I, _I] + [_P] * 22 + [_I, _I, _I, _P],
}


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str):
    """Raise if a C entry point reported a launch error."""
    if err == -1:
        raise ValueError(f"{what}: no kernel instantiation for these "
                         f"arguments")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
