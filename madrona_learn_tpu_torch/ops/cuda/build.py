"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own nvcc process, all started
together, and the objects are linked into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds). The library goes
into ``madrona_learn_tpu_torch/_build/<hash>/``, keyed by a hash of the
sources and flags, so a checkout builds once and any edit to a source
rebuilds. Nothing is built or loaded at import time: the first kernel launch
calls :func:`library`.
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
    "-Xcompiler", "-fPIC",
    # Per-kernel registers, shared memory and spills, kept in build.log.
    "--resource-usage",
)


@dataclass
class Kernel:
    """One hand-written kernel: what it replaces and how often it ran.

    ``launches`` is incremented by the kernel's wrapper where, and only
    where, it launches the kernel on the card; ``tc_launches`` as well where
    that launch took the kernel's tensor-core route (the LSTM kernels,
    the GRU kernels, ``mha`` and the fused step, whose path rules send
    bf16 there).
    """

    name: str
    source: str
    replaces: str
    launches: int = 0
    tc_launches: int = 0


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
    nvcc = find_nvcc()
    pid = os.getpid()
    objects, cmds = [], []
    for src in _sources():
        if src.suffix == ".cu":
            # nvcc reads an input's type from its suffix: keep ".o" last.
            objects.append(out_dir / f"{src.stem}.{pid}.o")
            cmds.append([nvcc, *NVCC_FLAGS, "-c", "-o", str(objects[-1]),
                         str(src)])
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outputs = [(cmd, proc.communicate()[0], proc.returncode)
               for cmd, proc in zip(cmds, procs)]
    tmp_path = out_dir / f"{LIB_NAME}.{pid}.tmp"
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_path),
            *(str(o) for o in objects)]
    if all(rc == 0 for _, _, rc in outputs):
        proc = subprocess.run(link, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        outputs.append((link, proc.stdout, proc.returncode))
    (out_dir / "build.log").write_text("".join(
        " ".join(cmd) + "\n" + out for cmd, out, _ in outputs))
    for obj in objects:
        obj.unlink(missing_ok=True)
    failed = [(cmd, out, rc) for cmd, out, rc in outputs if rc != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "".join(
            f"{' '.join(cmd)} (exit code {rc})\n{out}"
            for cmd, out, rc in failed))
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
    # gamma * lambda, steps a chunk, columns a block, stream
    "mlt_gae": [_P, _P, _P, _P, _P, _I, _I, _F, _F, _I, _I, _P],
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
    # as mlt_policy_step, without the dtype
    "mlt_policy_step_tc": [_I] * 4 + [_P] * 21 + [_P],
    # dtype, H, F, x, keep, wi, wr, bias, c0, h0, ys, cs, T, N, stream
    "mlt_lstm_proj_fwd": [_I, _I, _I] + [_P] * 9 + [_I, _I, _P],
    # dtype, H, F, x, keep, wi, wi_t, wr, wr_t, bias, c0, h0, ys, cs, dys,
    # dx, dg, dh0, dc0, part_wi, part_w, part_b, dwi, dwr, db, T, N,
    # splits, stream
    "mlt_lstm_proj_bwd": [_I, _I, _I] + [_P] * 22 + [_I, _I, _I, _P],
    # dtype, H, xp, keep, wh, bias_h, h0, ys, T, N, stream
    "mlt_gru_fwd": [_I, _I] + [_P] * 6 + [_I, _I, _P],
    # dtype, H, xp, keep, wh, wh_t, bias_h, h0, ys, dys, dxp, dhp, dh0,
    # part_w, part_b, dwh, db3, T, N, splits, stream
    "mlt_gru_bwd": [_I, _I] + [_P] * 15 + [_I, _I, _I, _P],
    # dtype, D, x, w, b, y, mu, rsigma, N, eps, stream
    "mlt_layer_norm_fwd": [_I, _I] + [_P] * 6 + [_I, _F, _P],
    # dtype, D, x, w, mu, rsigma, dy, dx, part, dw, db, N, partials,
    # phases, stream
    "mlt_layer_norm_bwd": [_I, _I] + [_P] * 9 + [_I, _I, _I, _P],
    # dtype, D, q, k, v, out, lse, B, S, H, valid_len, scale, stream
    "mlt_mha_flash_fwd": [_I, _I] + [_P] * 5 + [_I] * 4 + [_F, _P],
    # dtype, D, q, k, v, dout, lse, delta, dk, dv, B, S, H, valid_len,
    # scale, stream
    "mlt_mha_flash_bwd_dkdv": [_I, _I] + [_P] * 8 + [_I] * 4 + [_F, _P],
    # dtype, D, q, k, v, dout, lse, delta, dq, B, S, H, valid_len, scale,
    # stream
    "mlt_mha_flash_bwd_dq": [_I, _I] + [_P] * 7 + [_I] * 4 + [_F, _P],
    # dtype, tensor_core, x, weights, chunk_policy, y, B, C, IN, P, OUT,
    # stream
    "mlt_grouped_matmul": [_I, _I] + [_P] * 4 + [_I] * 5 + [_P],
    # H, F, phases, x, keep, wi, wi_t, wr, wr_t, bias, c0, h0, ys, cs, dys,
    # dx, dg, hin, dh0, dc0, part_w, part_b, dw, db, T, N, splits, stream
    "mlt_lstm_bwd_tc": [_I] * 3 + [_P] * 21 + [_I] * 3 + [_P],
    # H, phases, xp, keep, wh, wh_t, bias_h, h0, ys, dys, dxp, dhp, hin,
    # dh0, part_w, part_b, dwh, dbh, T, N, splits, stream
    "mlt_gru_bwd_tc": [_I] * 2 + [_P] * 16 + [_I] * 3 + [_P],
    # H, F, x, keep, wi, wr, bias, c0, h0, ys, cs, T, N, stream
    "mlt_lstm_fwd_tc": [_I] * 2 + [_P] * 9 + [_I] * 2 + [_P],
    # tensor_core, dtype, H, xp, keep, wr, bias, chunk_policy, c0, h0, ys,
    # cs, T, chunks, C, P, stream
    "mlt_lstm_fwd_chunked": [_I] * 3 + [_P] * 9 + [_I] * 4 + [_P],
    # tensor_core, dtype, H, xp, keep, wr, wr_t, bias, chunk_policy, c0, h0,
    # ys, cs, dys, dxp, hin, dh0, dc0, part_w, part_b, dwr, db, T, chunks,
    # C, P, splits a chunk, stream
    "mlt_lstm_bwd_chunked": [_I] * 3 + [_P] * 19 + [_I] * 5 + [_P],
    # H, R, stages, xp, keep, wh, bias_h, h0, ys, T, N, stream
    "mlt_gru_fwd_tc": [_I] * 3 + [_P] * 6 + [_I] * 2 + [_P],
    # tensor_core, dtype, H, xp, keep, wh, bias_h, chunk_policy, h0, ys, T,
    # chunks, C, P, stream
    "mlt_gru_fwd_chunked": [_I] * 3 + [_P] * 7 + [_I] * 4 + [_P],
    # tensor_core, dtype, H, xp, keep, wh, wh_t, bias_h, chunk_policy, h0,
    # ys, dys, dxp, dhp, hin, dh0, part_w, part_b, dwh, db, T, chunks, C, P,
    # splits a chunk, stream
    "mlt_gru_bwd_chunked": [_I] * 3 + [_P] * 17 + [_I] * 5 + [_P],
    # D, q, k, v, out, B, S, H, valid_len, scale * log2(e), stream
    "mlt_mha_fwd_tc": [_I] + [_P] * 4 + [_I] * 4 + [_F, _P],
    # tensor_core, dtype, H, layers, F, chunks, C, P, chunk_policy, x,
    # (w, ln_scale, ln_bias) x 4, wi, wr, bias, c, h, feats, c_out, h_out,
    # stream
    "mlt_policy_step_chunked": [_I] * 8 + [_P] * 22 + [_P],
    # tensor_core, dtype, H, F, x, keep, wi, wr, bias, chunk_policy, c0, h0,
    # ys, cs, T, chunks, C, P, stream
    "mlt_lstm_proj_fwd_chunked": [_I] * 4 + [_P] * 10 + [_I] * 4 + [_P],
    # tensor_core, dtype, H, F, x, keep, wi, wi_t, wr, wr_t, bias,
    # chunk_policy, c0, h0, ys, cs, dys, dx, dg, hin, dh0, dc0, part_wi,
    # part_w, part_b, dwi, dwr, db, T, chunks, C, P, splits a chunk, stream
    "mlt_lstm_proj_bwd_chunked": [_I] * 4 + [_P] * 24 + [_I] * 5 + [_P],
    # dtype, D, x, scale, bias, chunk_policy, y, mu, rsigma, chunks, C, P,
    # eps, stream
    "mlt_layer_norm_fwd_chunked": [_I, _I] + [_P] * 7 + [_I] * 3 + [_F, _P],
    # dtype, D, x, scale, chunk_policy, mu, rsigma, dy, dx, part, dscale,
    # dbias, chunks, C, P, partials, stream
    "mlt_layer_norm_bwd_chunked": [_I, _I] + [_P] * 10 + [_I] * 4 + [_P],
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


def check_operand(kernel: str, name: str, x, dtype, shape):
    """Raise unless ``x`` is a contiguous CUDA tensor of this dtype and
    shape, the only operands the kernels take."""
    if (x.device.type != "cuda" or x.dtype != dtype
            or tuple(x.shape) != tuple(shape) or not x.is_contiguous()):
        raise ValueError(
            f"{kernel}: {name} must be a contiguous {dtype} CUDA tensor of "
            f"shape {tuple(shape)}, got {x.dtype} {tuple(x.shape)} on "
            f"{x.device} (contiguous={x.is_contiguous()})")


def check(err: int, what: str):
    """Raise if a C entry point reported a launch error."""
    if err == -1:
        raise ValueError(f"{what}: no kernel instantiation for these "
                         f"arguments")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
