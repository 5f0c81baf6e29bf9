"""The native (C++) batched simulator behind the sim contract (JAX:
madrona_learn_tpu/envs/native_sim.py).

The C++ gridworld in ``native/batch_sim.cpp`` stands in for an opaque
external engine such as Madrona's: the trainer sees it only through
``sim_fns``. Its step is stateless (every state array goes in and comes
out), so training stays deterministic. The dynamics match
``envs/toy_env.py`` (same obs, actions and rewards).

The library is compiled from the checkout's source with g++ (the flags of
``native/Makefile``) into ``madrona_learn_tpu_torch/_build/native/<hash>/``,
keyed by a hash of the source, the flags and the compiler's version, and
bound with ctypes. Each step copies the actions and resets to host int32
arrays, calls the library, and returns every tensor on the caller's device.
PyTorch calls the library directly, so the JAX package's
``native_sim_ffi.py`` (which exists to put the step inside an XLA program)
has no counterpart.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

_REPO_DIR = Path(__file__).resolve().parents[2]
_SOURCE = _REPO_DIR / "native" / "batch_sim.cpp"
_BUILD_DIR = _REPO_DIR / "madrona_learn_tpu_torch" / "_build" / "native"
_CXX = "g++"
# native/Makefile's CXXFLAGS and LDFLAGS.
_CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
              "-shared")
_LD_FLAGS = ("-lpthread",)

_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def build() -> Path:
    """Compile ``native/batch_sim.cpp`` if this exact source, flag set and
    compiler were not built yet; return the library's path."""
    version = subprocess.run([_CXX, "--version"], capture_output=True,
                             text=True, check=True).stdout
    digest = hashlib.sha256(" ".join(_CXX_FLAGS + _LD_FLAGS).encode())
    digest.update(version.encode())
    digest.update(_SOURCE.read_bytes())
    out_dir = _BUILD_DIR / digest.hexdigest()[:16]
    lib_path = out_dir / "libbatch_sim.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp_path = out_dir / f"libbatch_sim.so.{os.getpid()}.tmp"
    cmd = [_CXX, *_CXX_FLAGS, str(_SOURCE), "-o", str(tmp_path), *_LD_FLAGS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp_path, lib_path)
    return lib_path


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.batch_sim_init.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64,
        _I32P, _I32P, _I32P, _I32P, _F32P, _F32P,
    ]
    lib.batch_sim_init.restype = None
    lib.batch_sim_step.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
        ctypes.c_int32,
        _I32P, _I32P, _I32P, _I32P, _I32P, _I32P,
        _I32P, _I32P, _I32P, _I32P, _F32P, _F32P, _F32P, _U8P,
    ]
    lib.batch_sim_step.restype = None
    return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _host_i32(t):
    return np.ascontiguousarray(t.detach().cpu().numpy(), np.int32)


@dataclass(frozen=True)
class NativeSimConfig:
    num_worlds: int
    episode_len: int = 40
    grid_size: int = 8
    seed: int = 0
    num_threads: int = 0  # 0 = os.cpu_count()

    @property
    def batch_size(self) -> int:
        return self.num_worlds


def make_native_sim(cfg: NativeSimConfig, device="cuda"):
    """``sim_fns`` backed by the C++ batched simulator, with every tensor
    it returns on ``device`` (the CUDA card unless the caller asks for
    another)."""
    lib = _library()
    n = cfg.batch_size
    threads = cfg.num_threads or (os.cpu_count() or 1)

    def to_dev(arr):
        return torch.from_numpy(arr).to(device)

    def init_fn():
        pos = np.empty((n, 2), np.int32)
        tgt = np.empty((n, 2), np.int32)
        t = np.empty((n, 1), np.int32)
        rng_ctr = np.empty((n, 1), np.int32)
        obs_delta = np.empty((n, 2), np.float32)
        obs_time = np.empty((n, 1), np.float32)
        lib.batch_sim_init(
            n, cfg.grid_size, cfg.seed,
            _ptr(pos, ctypes.c_int32), _ptr(tgt, ctypes.c_int32),
            _ptr(t, ctypes.c_int32), _ptr(rng_ctr, ctypes.c_int32),
            _ptr(obs_delta, ctypes.c_float), _ptr(obs_time, ctypes.c_float))
        state = {"pos": to_dev(pos), "target": to_dev(tgt), "t": to_dev(t),
                 "rng_ctr": to_dev(rng_ctr)}
        return {"state": state,
                "obs": {"delta": to_dev(obs_delta), "time": to_dev(obs_time)}}

    def step_fn(step_input):
        state = step_input["state"]
        pos, tgt, t, rng_ctr = (_host_i32(state[k]) for k in
                                ("pos", "target", "t", "rng_ctr"))
        actions = _host_i32(step_input["actions"]["move"])
        resets = _host_i32(step_input["resets"])
        resets = np.ascontiguousarray(
            np.repeat(resets, n // resets.shape[0], axis=0))

        pos_out = np.empty_like(pos)
        tgt_out = np.empty_like(tgt)
        t_out = np.empty_like(t)
        rng_out = np.empty_like(rng_ctr)
        obs_delta = np.empty((n, 2), np.float32)
        obs_time = np.empty((n, 1), np.float32)
        rewards = np.empty((n, 1), np.float32)
        dones = np.empty((n, 1), np.uint8)
        lib.batch_sim_step(
            n, cfg.grid_size, cfg.episode_len, cfg.seed, threads,
            _ptr(pos, ctypes.c_int32), _ptr(tgt, ctypes.c_int32),
            _ptr(t, ctypes.c_int32), _ptr(rng_ctr, ctypes.c_int32),
            _ptr(actions, ctypes.c_int32), _ptr(resets, ctypes.c_int32),
            _ptr(pos_out, ctypes.c_int32), _ptr(tgt_out, ctypes.c_int32),
            _ptr(t_out, ctypes.c_int32), _ptr(rng_out, ctypes.c_int32),
            _ptr(obs_delta, ctypes.c_float), _ptr(obs_time, ctypes.c_float),
            _ptr(rewards, ctypes.c_float), _ptr(dones, ctypes.c_uint8))

        return {
            "state": {"pos": to_dev(pos_out), "target": to_dev(tgt_out),
                      "t": to_dev(t_out), "rng_ctr": to_dev(rng_out)},
            "obs": {"delta": to_dev(obs_delta), "time": to_dev(obs_time)},
            "rewards": to_dev(rewards),
            "dones": to_dev(dones).bool(),
            "pbt": {"episode_results": torch.zeros(
                (cfg.num_worlds, 1), dtype=torch.int32, device=device)},
        }

    return {"init": init_fn, "step": step_fn}
