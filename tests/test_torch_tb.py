"""The port's TensorBoard event writer (``utils/tb.py``, which imports no
tensorboard, TensorFlow or imaging package): its records framed as
TensorBoard reads them (a little-endian length and the data, each followed
by its masked CRC-32C, checked here by a bitwise CRC-32C of the test's own),
each an ``Event`` parsed with tensorboard's protobuf classes, with the
fields ``torch.utils.tensorboard.SummaryWriter`` writes for the same call:
the file version first, scalars as ``simple_value``, images as 8-bit RGB
PNGs (gray repeated). Last, phase A of the reconstruction's ``train``
writes its scalar at the JAX ``train``'s tags, steps and values."""
import glob
import os
import struct

import numpy as np
import pytest

from fluidnexus_torch.utils.tb import TrainLogger, crc32c
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)


def _bitwise_crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c ^= b
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 & -(c & 1))
    return c ^ 0xFFFFFFFF


def _masked(data: bytes) -> int:
    c = _bitwise_crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _records(folder):
    (path,) = glob.glob(os.path.join(folder, "events.out.tfevents.*"))
    with open(path, "rb") as f:
        data = f.read()
    out, pos = [], 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", data[pos + 8:pos + 12])[0] == _masked(header)
        body = data[pos + 12:pos + 12 + n]
        assert struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])[0] == _masked(body)
        out.append(body)
        pos += 16 + n
    return out


def test_event_file_holds_summary_writer_events(tmp_path):
    from tensorboard.compat.proto.event_pb2 import Event

    from fluidnexus_torch.utils.png import read_png

    rng = np.random.default_rng(0)
    hwc = rng.uniform(-0.2, 1.2, (9, 13, 3)).astype(np.float32)
    chw_gray = rng.uniform(0, 1, (1, 6, 10)).astype(np.float32)
    w = TrainLogger(str(tmp_path / "run"))
    w.add_scalar("level_two/loss", 0.125, 0)
    w.add_scalar("level_two/loss", np.float32(1.0) / 3, 7)
    w.add_scalar("train/loss", -2.5e-7, 123456789)
    w.add_image("render/0", hwc, 0)
    w.add_image("render/1", chw_gray, 1)
    events = [Event.FromString(r) for r in _records(str(tmp_path / "run"))]
    assert len(events) == 6 and events[0].file_version == "brain.Event:2"
    scalars = [(e.step, v.tag, np.float32(v.simple_value))
               for e in events[1:4] for v in e.summary.value]
    assert scalars == [(0, "level_two/loss", np.float32(0.125)),
                       (7, "level_two/loss", np.float32(1.0) / 3),
                       (123456789, "train/loss", np.float32(-2.5e-7))]
    want = {"render/0": np.clip(hwc * 255, 0, 255).astype(np.uint8),
            "render/1": np.repeat(np.clip(chw_gray * 255, 0, 255).astype(np.uint8)
                                  .transpose(1, 2, 0), 3, -1)}
    for step, e in enumerate(events[4:]):
        (v,) = e.summary.value
        im = v.image
        assert e.step == step and e.wall_time > 0
        assert (im.height, im.width, im.colorspace) == want[v.tag].shape
        (tmp_path / "decoded.png").write_bytes(im.encoded_image_string)
        np.testing.assert_array_equal(read_png(str(tmp_path / "decoded.png")), want[v.tag])


def test_crc32c_and_a_logger_without_a_folder(tmp_path):
    assert crc32c(b"123456789") == 0xE3069283   # the CRC-32C check value
    blob = np.random.default_rng(1).integers(0, 256, 999).astype(np.uint8).tobytes()
    assert crc32c(blob) == _bitwise_crc32c(blob)
    w = TrainLogger("")
    w.add_scalar("a", 1.0, 0)
    w.add_image("b", np.zeros((4, 4), np.float32), 0)
    w.image_grid("g", np.zeros((3, 4, 4), np.float32), 0)
    assert os.listdir(tmp_path) == []


def test_scalar_scalars_and_enabled(tmp_path):
    """``scalar`` writes what ``add_scalar`` writes; ``scalars`` writes each
    entry of a dict under ``prefix/key`` and skips a value that is not one
    number, as the JAX package's logger does; ``enabled`` is whether a
    folder was given."""
    from tensorboard.compat.proto.event_pb2 import Event

    w = TrainLogger(str(tmp_path / "run"))
    assert w.enabled and not TrainLogger("").enabled
    w.scalar("train/loss", 0.5, 3)
    w.scalars("perf", {"peak_mib": 1024.0, "in_use_mib": np.float32(7.5), "shape": (1, 2)}, 4)
    events = [Event.FromString(r) for r in _records(str(tmp_path / "run"))]
    got = [(e.step, v.tag, v.simple_value) for e in events[1:] for v in e.summary.value]
    assert got == [(3, "train/loss", 0.5), (4, "perf/peak_mib", 1024.0),
                   (4, "perf/in_use_mib", 7.5)]


def test_device_memory_stats_is_empty_on_the_cpu():
    """No allocator to read on the CPU: the JAX package's ``{}``."""
    from fluidnexus_torch.utils.tb import device_memory_stats

    assert device_memory_stats("cpu") == {}
    assert device_memory_stats(None) == {} or set(device_memory_stats(None)) == {
        "peak_mib", "in_use_mib", "limit_mib"}


class _StopAfterPhaseA(BaseException):
    pass


class _Recorder:
    """The JAX ``train``'s writer: records (tag, value, step)."""

    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))


def test_phase_a_scalar_is_jax_s(tmp_path, monkeypatch):
    """Phase A of ``train`` writes ``train_loss_frame_000/total`` at JAX's
    steps (every 50th of 101 iterations) and values (the fit's losses, 1e-4
    relative, as in ``tests/test_torch_fit_first_frame.py``); both runs stop
    where phase B starts."""
    from tensorboard.compat.proto.event_pb2 import Event

    from fluidnexus_torch.core.config import Config as TConfig
    from fluidnexus_torch.pipelines import train_physical_particle as ttrain
    from fluidnexus_tpu.core.config import Config as JConfig
    from fluidnexus_tpu.pipelines import train_physical_particle as jtrain
    from tests.test_torch_fit_first_frame import _port_scene, _small
    from tests.test_train_physical import smoke_like_scene

    def stop(*a, **k):
        raise _StopAfterPhaseA

    scene = smoke_like_scene()
    cfg_j, cfg_t = _small(JConfig()), _small(TConfig())
    for cfg in (cfg_j, cfg_t):
        cfg.optim.iterations_per_time_first = 101
    cfg_j.pipe.backend = "xla"
    monkeypatch.setattr(jtrain, "make_particle_state", stop)
    monkeypatch.setattr(ttrain, "stabilize_hidden", stop)
    rec = _Recorder()
    with pytest.raises(_StopAfterPhaseA):
        jtrain.train(cfg_j, scene, writer=rec, log=lambda *a: None)
    with pytest.raises(_StopAfterPhaseA):
        ttrain.train(cfg_t, _port_scene(scene), writer=TrainLogger(str(tmp_path / "run")),
                     log=lambda *a: None, device="cpu")
    events = [Event.FromString(r) for r in _records(str(tmp_path / "run"))[1:]]
    got = [(v.tag, v.simple_value, e.step) for e in events for v in e.summary.value]
    assert [(t, s) for t, _, s in got] == [(t, s) for t, _, s in rec.scalars] == [
        ("train_loss_frame_000/total", 50), ("train_loss_frame_000/total", 100)]
    np.testing.assert_allclose([v for _, v, _ in got], [v for _, v, _ in rec.scalars],
                               rtol=1e-4)
