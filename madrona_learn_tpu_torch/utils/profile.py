"""Named profiling ranges (JAX: madrona_learn_tpu/utils/profile.py).

Usage::

    with profile("Collect Rollouts"):
        ...

A range shows in a ``torch.profiler`` trace as a ``record_function`` of
that name, and, once the process has initialized CUDA, as an NVTX range
on the card's timeline. ``record_function`` costs microseconds an entry
even with no profiler running, and the rollout loop is paced by the host,
so a range enters it only while a profiler is active
(``torch.autograd._profiler_enabled()``, a tenth of a microsecond). NVTX
is pushed only after CUDA is initialized: a CPU build of torch raises on
every NVTX call. ``profile.disable()`` turns every range into a no-op.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

__all__ = ["profile"]

_NULL = nullcontext()


class _Range:
    __slots__ = ("name", "record", "nvtx")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.record = None
        if torch.autograd._profiler_enabled():
            self.record = torch.profiler.record_function(self.name)
            self.record.__enter__()
        self.nvtx = torch.cuda.is_initialized()
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        if self.record is not None:
            self.record.__exit__(*exc)
        return False


class Profiler:
    def __init__(self):
        self.disabled = False

    def __call__(self, name: str):
        return _NULL if self.disabled else _Range(name)

    def disable(self):
        self.disabled = True

    def enable(self):
        self.disabled = False


profile = Profiler()
