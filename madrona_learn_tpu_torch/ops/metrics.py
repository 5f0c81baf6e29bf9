"""Welford metrics in a per-policy ring buffer (JAX: ops/metrics.py).

A ``Metric`` holds mean / m2 / min / max / count tensors; merges use the
parallel-Welford combine, so partial metrics reduce exactly. In
``TrainingMetrics`` every per-policy metric field is shaped
``[num_policies, buffer_size]`` and every other field ``[buffer_size]``;
``record`` summarizes raw arrays (leading policy axis for per-policy
metrics) into the current slot and ``advance`` moves to the next slot.
``for_policy(p)`` is a view whose writes land in policy p's row, the one a
PBT train policy's PPO update records into. ``pretty_print`` and
``tensorboard_log`` report on the host, with the JAX package's text, tags
and steps.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, fields, replace
from typing import Dict

import numpy as np
import torch

_F32 = torch.float32
_F32_MAX = float(np.finfo(np.float32).max)
_F32_MIN = float(np.finfo(np.float32).min)


def _flatten_from(x, start_dim):
    return x.reshape(*x.shape[:start_dim], -1)


@dataclass
class Metric:
    per_policy: bool
    mean: torch.Tensor
    m2: torch.Tensor
    min: torch.Tensor
    max: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def init(per_policy: bool, shape=(), device=None) -> "Metric":
        full = lambda v, dt: torch.full(shape, v, dtype=dt, device=device)
        return Metric(per_policy, full(0.0, _F32), full(0.0, _F32),
                      full(_F32_MAX, _F32), full(_F32_MIN, _F32),
                      full(0, torch.int32))

    @staticmethod
    def init_from_data(per_policy: bool, data, start_dim=0) -> "Metric":
        """Statistics over all dims from ``start_dim`` on."""
        flat = _flatten_from(data.to(_F32), start_dim)
        mean = flat.mean(dim=-1)
        deltas = flat - mean.unsqueeze(-1)
        return Metric(
            per_policy, mean, (deltas * deltas).sum(dim=-1),
            flat.amin(dim=-1), flat.amax(dim=-1),
            torch.full_like(mean, flat.shape[-1], dtype=torch.int32))

    @staticmethod
    def init_from_data_masked(per_policy: bool, data, mask,
                              start_dim=0) -> "Metric":
        """Welford stats over the elements where ``mask`` is true."""
        mask = _flatten_from(mask.to(torch.bool), start_dim)
        flat = _flatten_from(data.to(_F32), start_dim)
        count = mask.sum(dim=-1, dtype=torch.int32)
        safe_count = torch.clamp(count, min=1).to(_F32)
        zeros = torch.zeros_like(flat)
        mean = torch.where(mask, flat, zeros).sum(dim=-1) / safe_count
        deltas = torch.where(mask, flat - mean.unsqueeze(-1), zeros)
        return Metric(
            per_policy, mean, (deltas * deltas).sum(dim=-1),
            torch.where(mask, flat, _F32_MAX).amin(dim=-1),
            torch.where(mask, flat, _F32_MIN).amax(dim=-1), count)

    def merge(self, other: "Metric") -> "Metric":
        """Parallel-Welford combine; exact under any partition of the
        data."""
        new_count = self.count + other.count
        delta = other.mean - self.mean
        safe_denom = 1.0 / torch.clamp(new_count.to(_F32), min=1)
        mean = self.mean + delta * other.count.to(_F32) * safe_denom
        m2 = (self.m2 + other.m2
              + delta * delta * self.count.to(_F32)
              * other.count.to(_F32) * safe_denom)
        return replace(self, mean=mean, m2=m2,
                       min=torch.minimum(self.min, other.min),
                       max=torch.maximum(self.max, other.max),
                       count=new_count)

    def tensors(self):
        return {f.name: getattr(self, f.name) for f in fields(self)
                if f.name != "per_policy"}


class TrainingMetrics:
    """Ring buffer of metrics over the last ``buffer_size`` updates."""

    def __init__(self, metrics: Dict[str, Metric], buffer_size: int,
                 start_update_idx: int, num_policies: int, device=None):
        self.metrics = {
            name: Metric.init(
                m.per_policy,
                (num_policies, buffer_size) if m.per_policy
                else (buffer_size,), device)
            for name, m in metrics.items()
        }
        self.update_idx = start_update_idx
        self.cur_buffer_offset = 0
        self.buffer_size = buffer_size
        self._policies = slice(None)

    def for_policy(self, p: int) -> "TrainingMetrics":
        """A view of these metrics that writes per-policy metrics into
        policy ``p``'s row only."""
        view = copy.copy(self)
        view._policies = slice(p, p + 1)
        return view

    def _write(self, name, value: Metric):
        slot = self.metrics[name]
        for field, t in value.tensors().items():
            dst = getattr(slot, field)
            if slot.per_policy:
                dst[self._policies, self.cur_buffer_offset] = t
            else:
                dst[..., self.cur_buffer_offset] = t

    def update_metrics(self, metrics: Dict[str, Metric]):
        """Write pre-built Metric values into the current slot."""
        for name, value in metrics.items():
            self._write(name, value)

    def record(self, data: Dict[str, torch.Tensor]):
        """Summarize raw arrays into the current slot. Per-policy metrics
        take arrays with a leading policy axis."""
        for name, arr in data.items():
            per_policy = self.metrics[name].per_policy
            self._write(name, Metric.init_from_data(
                per_policy, arr, start_dim=1 if per_policy else 0))

    def advance(self):
        self.update_idx += 1
        self.cur_buffer_offset = (self.cur_buffer_offset + 1) \
            % self.buffer_size

    def _on_host(self):
        """Every metric's fields as numpy arrays, one copy a tensor."""
        return {name: (m.per_policy, {k: v.cpu().numpy()
                                      for k, v in m.tensors().items()})
                for name, m in self.metrics.items()}

    def pretty_print(self, tab=2):
        """Print the most recently recorded buffer slot of every metric."""
        tab = " " * tab
        last = (self.cur_buffer_offset - 1) % self.buffer_size

        def fmt(x):
            return ", ".join(f"{float(v): .3e}" for v in
                             np.atleast_1d(x[..., last]))

        lines = [tab + "TrainingMetrics"]
        for name, (_, m) in self._on_host().items():
            with np.errstate(invalid="ignore", divide="ignore"):
                stddev = np.sqrt(m["m2"] / m["count"])
            lines.append(tab * 2 + f"{name}:")
            lines.append(tab * 3 + f"Avg: {fmt(m['mean'])}")
            lines.append(tab * 3 + f"Min: {fmt(m['min'])}")
            lines.append(tab * 3 + f"Max: {fmt(m['max'])}")
            lines.append(tab * 3 + f"sigma: {fmt(stddev)}")
        print("\n".join(lines))

    def tensorboard_log(self, base_update_idx: int, writer):
        """Every buffer slot ``i`` of every metric as the scalars
        ``<name> Mean`` / ``sigma`` / ``Min`` / ``Max`` at step
        ``base_update_idx + i``, per-policy metrics as ``p<i>/<name> ...``
        for every policy."""
        host = self._on_host()
        with np.errstate(invalid="ignore", divide="ignore"):
            for buf_idx in range(self.buffer_size):
                out_idx = base_update_idx + buf_idx
                for name, (per_policy, m) in host.items():
                    rows = ([(f"p{i}/{name}", (i, buf_idx))
                             for i in range(m["mean"].shape[0])]
                            if per_policy else [(name, buf_idx)])
                    for tag, at in rows:
                        stddev = np.sqrt(m["m2"][at] / m["count"][at])
                        writer.scalar(f"{tag} Mean", m["mean"][at], out_idx)
                        writer.scalar(f"{tag} sigma", stddev, out_idx)
                        writer.scalar(f"{tag} Min", m["min"][at], out_idx)
                        writer.scalar(f"{tag} Max", m["max"][at], out_idx)

    def latest(self, name: str) -> Metric:
        """A copy of the most recently completed slot of one metric."""
        slot = (self.cur_buffer_offset - 1) % self.buffer_size
        m = self.metrics[name]
        return Metric(m.per_policy, **{
            k: v[..., slot].clone() for k, v in m.tensors().items()})
