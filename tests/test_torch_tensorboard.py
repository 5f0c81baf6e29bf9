"""The port's TensorBoard and W&B writers and its metrics' reporting,
against the JAX package's.

The port's writer frames TFRecords and encodes the ``Event`` protobuf by
hand; the JAX package's goes through the ``tensorboard`` package. For the
same summaries both files must read back, through the installed
``tensorboard``'s raw event loader, as the same ``(tag, step, value)``
sets: scalars bitwise (float32), text the same bytes and plugin, images
the same size, colorspace and decoded pixels. The port's own reader
(``read_events``) must read the JAX package's file the same way.
``TrainingMetrics.tensorboard_log`` / ``pretty_print`` must give JAX's
tags, steps, values and text exactly from the same ring buffers, after
the ring wrapped, with a per-policy metric over two policies and a slot
never written (count 0: sigma NaN).
"""

import contextlib
import io
import os
import sys
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from madrona_learn_tpu.ops.metrics import Metric as JMetric
from madrona_learn_tpu.ops.metrics import TrainingMetrics as JMetrics
from madrona_learn_tpu.utils.tensorboard import (
    TensorboardWriter as JWriter)
from madrona_learn_tpu_torch.ops.metrics import Metric, TrainingMetrics
from madrona_learn_tpu_torch.utils.tensorboard import (
    TensorboardWriter, crc32c, read_events, read_records)

IMAGE_RGB = (np.arange(5 * 7 * 3) * 37 % 256).astype(np.uint8).reshape(
    5, 7, 3)
IMAGE_RGBA = (np.arange(3 * 4 * 4) * 11 % 256).astype(np.uint8).reshape(
    3, 4, 4)


def _write_all(writer):
    writer.scalar("loss", np.float32(0.125), 0)
    writer.scalar("loss", np.float32(-3.5e-7), 7)
    writer.scalar("p1/Rewards Mean", np.float64(1.0 / 3.0), 2 ** 33)
    writer.scalar("nan", float("nan"), 3)
    writer.text("notes", "héllo, board", 4)
    writer.image("frame", IMAGE_RGB, 5)
    writer.image("frame_rgba", IMAGE_RGBA, 6)
    writer.flush()


def _event_file(logdir):
    (name,) = [f for f in os.listdir(logdir) if "tfevents" in f]
    return os.path.join(logdir, name)


def _loaded(path):
    """(tag, step, kind, value) of every summary value, and the first
    event's file_version, through tensorboard's raw loader."""
    from tensorboard.backend.event_processing.event_file_loader import (
        LegacyEventFileLoader)

    events = list(LegacyEventFileLoader(path).Load())
    out = set()
    for e in events[1:]:
        for v in e.summary.value:
            kind = v.WhichOneof("value")
            if kind == "simple_value":
                value = np.float32(v.simple_value).tobytes()
            elif kind == "image":
                pixels = np.asarray(Image.open(io.BytesIO(
                    v.image.encoded_image_string)))
                value = (v.image.height, v.image.width, v.image.colorspace,
                         pixels.shape, pixels.tobytes())
            else:
                value = (tuple(v.tensor.string_val), v.tensor.dtype,
                         tuple(d.size for d in v.tensor.tensor_shape.dim),
                         v.metadata.plugin_data.plugin_name)
            out.add((v.tag, e.step, kind, value))
    return events[0].file_version, out


def test_crc32c_known_answer():
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(b"") == 0


def test_event_files_read_the_same_as_jax(tmp_path):
    port = TensorboardWriter(str(tmp_path / "port"))
    _write_all(port)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_writer = JWriter(str(tmp_path / "jax"))
        _write_all(jax_writer)
    port_file = _event_file(str(tmp_path / "port"))
    jax_file = _event_file(str(tmp_path / "jax"))
    assert port.path == port_file

    version_p, got = _loaded(port_file)
    version_j, want = _loaded(jax_file)
    assert version_p == version_j == "brain.Event:2"
    assert len(got) == 7
    assert got == want


def test_port_reader_reads_jax_files(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_writer = JWriter(str(tmp_path / "jax"))
        _write_all(jax_writer)
    port = TensorboardWriter(str(tmp_path / "port"))
    _write_all(port)

    def summarize(path):
        events = read_events(path)
        assert events[0]["file_version"] == "brain.Event:2"
        out = []
        for e in events[1:]:
            for v in e["values"]:
                if "simple_value" in v:
                    value = np.float32(v["simple_value"]).tobytes()
                elif "image" in v:
                    im = v["image"]
                    value = (im["height"], im["width"], im["colorspace"],
                             np.asarray(Image.open(io.BytesIO(
                                 im["encoded_image_string"]))).tobytes())
                else:
                    value = (tuple(v["string_val"]), v["plugin_name"])
                out.append((v["tag"], e["step"], value))
        return sorted(out)

    assert summarize(_event_file(str(tmp_path / "port"))) == \
        summarize(_event_file(str(tmp_path / "jax")))


def test_reader_rejects_a_corrupt_record(tmp_path):
    port = TensorboardWriter(str(tmp_path))
    port.scalar("x", 1.0, 1)
    port.close()
    data = bytearray(open(port.path, "rb").read())
    assert len(read_records(port.path)) == 2
    data[-6] ^= 0x01  # a bit of the last payload
    open(port.path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="payload CRC"):
        read_records(port.path)


class _Recorder:
    def __init__(self):
        self.calls = []

    def scalar(self, tag, value, step):
        self.calls.append((tag, int(step),
                           np.float32(np.asarray(value)).tobytes()))


BUFFER, POLICIES = 3, 2
# (name, per-policy) in the order both packages keep them.
METRICS = (("Loss", False), ("Rewards", True), ("Entropy", False))


def _both_metrics(advances):
    """The same ring buffers in both packages, after ``advances`` calls
    of ``advance`` (past BUFFER the ring has wrapped). Every slot holds
    random values, but ``Entropy``'s last slot keeps the init values
    (count 0, as a slot never written)."""
    from flax.core import FrozenDict

    jm = JMetrics.create({name: JMetric.init(pp) for name, pp in METRICS},
                         BUFFER, 0, POLICIES)
    tm = TrainingMetrics({name: Metric.init(pp) for name, pp in METRICS},
                         BUFFER, 0, POLICIES)
    rng = np.random.default_rng(3)
    jax_metrics = {}
    for name, pp in METRICS:
        shape = (POLICIES, BUFFER) if pp else (BUFFER,)
        values = {"mean": rng.normal(size=shape).astype(np.float32),
                  "m2": rng.random(shape).astype(np.float32) * 10,
                  "min": rng.normal(size=shape).astype(np.float32) - 3,
                  "max": rng.normal(size=shape).astype(np.float32) + 3,
                  "count": rng.integers(1, 50, size=shape).astype(np.int32)}
        if name == "Entropy":
            init = Metric.init(False)
            for k, v in values.items():
                v[-1] = getattr(init, k).numpy()
        jax_metrics[name] = JMetric(per_policy=pp, **{
            k: jnp.asarray(v) for k, v in values.items()})
        tm.metrics[name] = Metric(pp, **{
            k: torch.from_numpy(v.copy()) for k, v in values.items()})
    jm = jm.replace(metrics=FrozenDict(jax_metrics))
    for _ in range(advances):
        jm = jm.advance()
        tm.advance()
    return jm, tm


def test_tensorboard_log_matches_jax():
    jm, tm = _both_metrics(advances=5)
    got, want = _Recorder(), _Recorder()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        # As the JAX TrainingManager.log_metrics_tensorboard calls it.
        jax.tree.map(np.asarray, jm).tensorboard_log(10, want)
    tm.tensorboard_log(10, got)
    assert len(got.calls) == BUFFER * 4 * (1 + POLICIES + 1)
    assert sorted(got.calls) == sorted(want.calls)
    tags = {tag for tag, _, _ in got.calls}
    assert {"p0/Rewards Mean", "p1/Rewards sigma", "Loss Max",
            "Entropy Min"} <= tags
    assert {step for _, step, _ in got.calls} == {10, 11, 12}


def test_pretty_print_matches_jax():
    jm, tm = _both_metrics(advances=4)

    def printed(metrics):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            metrics.pretty_print()
        return out.getvalue()

    text = printed(tm)
    assert text == printed(jm)
    assert "Rewards:" in text and "sigma:" in text


def test_log_metrics_tensorboard_writes_the_ring(tmp_path):
    """``TrainingManager.log_metrics_tensorboard`` through the port's
    writer: every slot's scalars at update_idx - 1 + slot, read back by
    the port's reader."""
    from madrona_learn_tpu_torch.train import TrainingManager

    _, tm = _both_metrics(advances=2)
    mgr = TrainingManager.__new__(TrainingManager)
    mgr.metrics, mgr.update_idx = tm, 2
    writer = TensorboardWriter(str(tmp_path))
    mgr.log_metrics_tensorboard(writer)
    recorder = _Recorder()
    tm.tensorboard_log(1, recorder)
    read = [(v["tag"], e["step"], np.float32(v["simple_value"]).tobytes())
            for e in read_events(writer.path)[1:] for v in e["values"]]
    assert read == recorder.calls


def test_wandb_writer_with_stub(tmp_path, monkeypatch):
    """WandbWriter mirrors scalars to wandb.log, against a stub module as
    tests/test_metrics_and_misc.py tests the JAX package's."""
    calls = {"init": [], "log": []}
    stub = types.ModuleType("wandb")
    stub.init = lambda **kw: calls["init"].append(kw)
    stub.log = lambda data, step=None: calls["log"].append((data, step))
    monkeypatch.setitem(sys.modules, "wandb", stub)

    from madrona_learn_tpu_torch.utils.wandb import WandbWriter

    writer = WandbWriter(str(tmp_path / "wb"), config={"lr": 1e-3},
                         project="p")
    writer.scalar("loss", 0.5, 3)
    writer.flush()

    assert calls["init"] == [{"sync_tensorboard": True,
                              "config": {"lr": 1e-3}, "project": "p"}]
    assert calls["log"] == [({"loss": 0.5}, 3)]
    events = read_events(writer.path)
    assert events[1]["values"] == [{"tag": "loss", "simple_value": 0.5}]
