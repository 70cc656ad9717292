"""The port's streaming ingest against the JAX package, on the CPU.

``ops/color.py`` (YUV functions), ``io/stream.py`` and ``io/batch.py``: the
same numpy-seeded arrays through both packages, ``device="cpu"``.
Tolerances: the device-side conversions 1e-4 on 0-255 (the same float32
operations in the same order; the two compilers may contract a multiply
and an add differently); the host packer byte for byte; the accounting
helpers equal.  The cases are those of ``tests/test_stream.py``.
"""

import ast
import inspect
import sys
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyannote_video_tpu.io import stream as jstream
from pyannote_video_tpu.ops import color as jcolor

from pyannote_video_tpu_torch.io import batch, stream
from pyannote_video_tpu_torch.io.video import Video
from pyannote_video_tpu_torch.ops import color

COLOR_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The test runner's workers share the cores: with every worker's torch
    pool at full width the many small CPU operations of a scan mostly wait
    for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _batches(n=4, b=6, h=32, w=48, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ts = np.arange(b, dtype=np.float64) + i * b
        frames = rng.integers(0, 255, size=(b, h, w, 3), dtype=np.uint8)
        out.append((ts, frames))
    return out


def _smooth():
    gx = np.linspace(0, 255, 48, dtype=np.float32)
    gy = np.linspace(0, 255, 32, dtype=np.float32)
    return np.stack([np.tile(gx, (32, 1)), np.tile(gy[:, None], (1, 48)),
                     np.full((32, 48), 128.0)], axis=-1).astype(np.uint8)[None]


# -- ops/color.py -------------------------------------------------------------


class TestColor:
    def test_yuv_luma_to_gray(self):
        y = np.arange(256, dtype=np.uint8).reshape(1, 16, 16)
        ref = np.asarray(jcolor.yuv_luma_to_gray(jnp.asarray(y)))
        out = color.yuv_luma_to_gray(_t(y))
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref, atol=COLOR_TOL, rtol=0)
        assert out.min() == 0.0 and out.max() == 255.0
        # a new tensor, never a view of the plane it was given
        assert out.data_ptr() != _t(y).data_ptr()

    @pytest.mark.parametrize("size", [(32, 48), (31, 47), (2, 2), (5, 4)])
    def test_yuv420_to_rgb(self, size):
        H, W = size
        rng = np.random.default_rng(H * 100 + W)
        y = rng.integers(0, 256, (3, H, W), dtype=np.uint8)
        u = rng.integers(0, 256, (3, (H + 1) // 2, (W + 1) // 2), dtype=np.uint8)
        v = rng.integers(0, 256, u.shape, dtype=np.uint8)
        ref = np.asarray(jcolor.yuv420_to_rgb(*map(jnp.asarray, (y, u, v))))
        out = color.yuv420_to_rgb(_t(y), _t(u), _t(v))
        assert out.shape == (3, H, W, 3) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref, atol=COLOR_TOL, rtol=0)

    @pytest.mark.parametrize("dtype", [np.uint8, np.float32])
    def test_ingest_gray_resize_first(self, dtype):
        rng = np.random.default_rng(2)
        frames = rng.uniform(0, 255, (3, 40, 56, 3)).astype(dtype)
        ref = np.asarray(jcolor.ingest_gray_resize_first(
            jnp.asarray(frames), 21, 30))
        out = color.ingest_gray_resize_first(_t(frames), 21, 30)
        assert out.shape == (3, 21, 30)
        np.testing.assert_allclose(out.numpy(), ref, atol=COLOR_TOL, rtol=0)

    @pytest.mark.parametrize("shape", [(1, 2, 2), (5, 32, 48), (9, 120, 160),
                                       (2, 360, 640)])
    def test_rgb_to_yuv420_planes_equal_byte_for_byte(self, shape):
        """Noise is the hard case: a chroma mean lands within an ulp of .5
        on hundreds of samples, and only the same float32 operations in
        the same order round them all alike."""
        rng = np.random.default_rng(sum(shape))
        frames = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
        ref = jcolor.rgb_to_yuv420(frames)
        out = color.rgb_to_yuv420(frames)
        for a, b in zip(out, ref):
            assert a.dtype == np.uint8 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)

    def test_rgb_to_yuv420_on_smooth_and_flat_frames(self):
        flat = np.zeros((1, 16, 16, 3), np.uint8)
        flat[..., 0], flat[..., 1], flat[..., 2] = 180, 90, 40
        for frames in (_smooth(), flat, np.full((2, 4, 6, 3), 255, np.uint8)):
            for a, b in zip(color.rgb_to_yuv420(frames),
                            jcolor.rgb_to_yuv420(frames)):
                np.testing.assert_array_equal(a, b)

    def test_rgb_to_yuv420_takes_a_strided_view(self):
        frames = np.random.default_rng(3).integers(
            0, 256, (4, 16, 24, 3), dtype=np.uint8)
        for a, b in zip(color.rgb_to_yuv420(frames[::2, :, :, ::-1]),
                        jcolor.rgb_to_yuv420(frames[::2, :, :, ::-1])):
            np.testing.assert_array_equal(a, b)


# -- the packer ----------------------------------------------------------------


class TestPack:
    def test_pack_is_the_numpy_convention(self):
        _, noise = _batches(1)[0]
        for frames in (noise, _smooth()):
            for a, b in zip(stream.pack_yuv420(frames),
                            color.rgb_to_yuv420(frames)):
                np.testing.assert_array_equal(a, b)

    def test_pack_never_imports_cv2(self, monkeypatch):
        """One convention on every machine: no OpenCV path, neither in the
        source nor at run time."""
        for fn in (stream.pack_yuv420, color.rgb_to_yuv420):
            names = {n.id for n in ast.walk(ast.parse(inspect.getsource(fn)))
                     if isinstance(n, ast.Name)}
            imports = [n for n in ast.walk(ast.parse(inspect.getsource(fn)))
                       if isinstance(n, (ast.Import, ast.ImportFrom))]
            assert "cv2" not in names and not imports
        monkeypatch.setitem(sys.modules, "cv2", None)   # import cv2 → ImportError
        y, u, v = stream.pack_yuv420(_smooth())
        assert y.shape == (1, 32, 48) and u.shape == v.shape == (1, 16, 24)

    def test_against_the_jax_packer_as_its_own_test_holds_it(self):
        """The JAX packer (OpenCV here) and the port's differ as
        ``tests/test_stream.py`` says: luma ±1, chroma ±3 on smooth
        content."""
        pytest.importorskip("cv2")
        _, noise = _batches(1)[0]
        y1, _, _ = jstream.pack_yuv420(noise)
        y2, _, _ = stream.pack_yuv420(noise)
        assert np.abs(y1.astype(int) - y2.astype(int)).max() <= 1
        for a, b, tol in zip(jstream.pack_yuv420(_smooth()),
                             stream.pack_yuv420(_smooth()), (1, 3, 3)):
            assert np.abs(a.astype(int) - b.astype(int)).max() <= tol

    def test_roundtrip_through_device_unpack(self):
        x = np.zeros((1, 16, 16, 3), np.uint8)
        x[..., 0], x[..., 1], x[..., 2] = 180, 90, 40
        y, u, v = stream.pack_yuv420(x)
        rgb = color.yuv420_to_rgb(_t(y), _t(u), _t(v)).numpy()
        assert np.abs(rgb - x.astype(np.float32)).max() < 6.0

    def test_video_yuv_batches_needs_cv2(self, monkeypatch, tmp_path):
        monkeypatch.setitem(sys.modules, "cv2", None)
        with pytest.raises(ImportError):
            next(stream.video_yuv_batches(str(tmp_path / "none.avi"), 4))

    def test_video_yuv_batches_against_jax(self, tmp_path):
        cv2 = pytest.importorskip("cv2")
        path = str(tmp_path / "grad.avi")
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 25, (64, 48))
        for i in range(10):
            g = np.zeros((48, 64, 3), np.uint8)
            g[:, :, 0] = np.linspace(10 + 5 * i, 200, 64)[None, :]
            g[:, :, 1] = 90
            g[:, :, 2] = np.linspace(40, 150, 48)[:, None]
            w.write(g[:, :, ::-1])
        w.release()
        for drop_last, n in ((True, 2), (False, 3)):
            ref = list(jstream.video_yuv_batches(path, 4, drop_last=drop_last))
            out = list(stream.video_yuv_batches(path, 4, drop_last=drop_last))
            assert len(out) == len(ref) == n
            for (ts_o, planes_o), (ts_r, planes_r) in zip(out, ref):
                np.testing.assert_array_equal(ts_o, ts_r)
                for a, b in zip(planes_o, planes_r):
                    np.testing.assert_array_equal(a, b)


# -- _Stage and run_stream -----------------------------------------------------


def _compute(carry, ts, y, u, v):
    # running sum of luma, a deliberately carry-dependent program
    total = carry + y.to(torch.float32).sum()
    return total, total


def _jcompute(carry, ts, y, u, v):
    total = carry + jnp.sum(y.astype(jnp.float32))
    return total, total


class TestStage:
    @pytest.mark.parametrize("depth", [1, 2, 5])
    def test_equal_to_a_serial_loop(self, depth):
        items = list(range(23))
        seen = []
        stage = stream._Stage(items, lambda x: (seen.append(x), x * x)[1], depth)
        assert list(stage) == [x * x for x in items]
        assert seen == items
        assert stage.busy_s >= 0 and stage.pull_s >= 0 and stage.wait_s >= 0
        stage._thread.join(timeout=5)
        assert not stage._thread.is_alive()

    def test_two_stages_chained_keep_the_order(self):
        first = stream._Stage(range(50), lambda x: x + 1, 2)
        second = stream._Stage(first, lambda x: x * 2, 2)
        assert list(second) == [(x + 1) * 2 for x in range(50)]

    def test_backpressure_bounds_the_run_ahead(self):
        made = []
        stage = stream._Stage(range(100), lambda x: (made.append(x), x)[1], 2)
        it = iter(stage)
        assert next(it) == 0
        time.sleep(0.2)
        # one taken, two queued, one held by the blocked put
        assert len(made) <= 4
        assert list(it) == list(range(1, 100))

    @pytest.mark.parametrize("where", ["source", "fn"])
    def test_an_error_on_the_thread_reaches_the_consumer(self, where):
        def source():
            yield 1
            if where == "source":
                raise RuntimeError("decoder died")
            yield 2

        def fn(x):
            if where == "fn" and x == 2:
                raise RuntimeError("decoder died")
            return x

        got = []
        with pytest.raises(RuntimeError, match="decoder died"):
            for item in stream._Stage(source(), fn, 2):
                got.append(item)
        assert got == [1]

    def test_an_error_of_the_first_stage_passes_through_the_second(self):
        def source():
            yield 1
            raise ValueError("upstream")

        second = stream._Stage(stream._Stage(source(), lambda x: x, 2),
                               lambda x: x, 2)
        with pytest.raises(ValueError, match="upstream"):
            list(second)


class TestRunStream:
    @pytest.mark.parametrize("depth", [1, 2, 3])
    def test_matches_serial_reference_and_jax(self, depth):
        batches = _batches()
        carry, results, stats = stream.run_stream(
            batches, _compute, torch.tensor(0.0), depth=depth, device="cpu")
        ref = 0.0
        running = []
        for _, frames in batches:
            y, _, _ = stream.pack_yuv420(frames)
            ref += float(y.astype(np.float64).sum())
            running.append(ref)
        assert float(carry) == pytest.approx(ref, rel=1e-6)
        assert len(results) == len(batches)
        assert [float(r) for r in results] == pytest.approx(running, rel=1e-6)
        # the JAX run_stream on the same batches (its packer differs by ±1 in luma)
        jcarry, jresults, _ = jstream.run_stream(
            batches, _jcompute, jnp.float32(0.0), depth=depth)
        assert len(jresults) == len(results)
        n_px = sum(f.shape[0] * f.shape[1] * f.shape[2] for _, f in batches)
        assert abs(float(jcarry) - float(carry)) <= n_px

    def test_stats_accounting(self):
        batches = _batches()
        _, _, stats = stream.run_stream(batches, _compute, torch.tensor(0.0),
                                        depth=2, device="cpu")
        _, _, jstats = jstream.run_stream(batches, _jcompute, jnp.float32(0.0),
                                          depth=2)
        n = sum(len(ts) for ts, _ in batches)
        assert stats.frames == jstats.frames == n
        assert stats.batches == jstats.batches == len(batches)
        _, f0 = batches[0]
        assert stats.bytes_shipped == jstats.bytes_shipped == int(
            n * f0.shape[1] * f0.shape[2] * 1.5)
        assert stats.wall_s > 0 and stats.fps > 0 and stats.transfer_gbps > 0
        assert set(stats.as_dict()) == set(jstats.as_dict())

    def test_prepacked_source(self):
        batches = [(ts, stream.pack_yuv420(frames)) for ts, frames in _batches()]
        carry, _, stats = stream.run_stream(
            batches, _compute, torch.tensor(0.0), depth=2, pack=False,
            device="cpu")
        assert stats.pack_s < 1e-3  # no packing work, only timer ticks
        assert float(carry) == pytest.approx(
            sum(float(y.astype(np.float64).sum()) for _, (y, _, _) in batches),
            rel=1e-6)

    def test_feeder_error_propagates(self):
        def bad():
            yield _batches(1)[0]
            raise RuntimeError("decoder died")
        with pytest.raises(RuntimeError, match="decoder died"):
            stream.run_stream(bad(), _compute, torch.tensor(0.0), device="cpu")

    def test_a_short_last_batch_and_a_custom_sync(self):
        batches = _batches(3)
        batches[-1] = (batches[-1][0][:2], batches[-1][1][:2])
        synced = []
        _, results, stats = stream.run_stream(
            batches, lambda c, ts, y, u, v: (c, {"n": [y.shape[0] + 0 * y.sum()]}),
            None, sync=lambda res: synced.append(float(res["n"][0])),
            device="cpu")
        assert synced == [6.0, 6.0, 2.0] and stats.frames == 14
        assert float(stream._first_tensor(results[0])) == 6.0

    def test_planes_arrive_as_uint8_tensors_of_the_host_planes(self):
        batches = _batches(3)
        seen = []
        stream.run_stream(
            batches, lambda c, ts, y, u, v: (c, (seen.append((ts, y, u, v)), y)[1]),
            None, device="cpu")
        for (ts, frames), (ts_s, y, u, v) in zip(batches, seen):
            np.testing.assert_array_equal(ts_s, ts)
            for plane, ref in zip((y, u, v), stream.pack_yuv420(frames)):
                assert plane.dtype == torch.uint8 and plane.device.type == "cpu"
                np.testing.assert_array_equal(plane.numpy(), ref)


class TestShipper:
    def test_on_the_cpu_it_wraps_the_planes(self):
        ship = stream._Shipper(torch.device("cpu"), depth=2)
        planes = stream.pack_yuv420(_batches(1)[0][1])
        out = ship.take(ship.put(planes))
        assert ship.pinned_bytes == 0
        for a, b in zip(out, planes):
            np.testing.assert_array_equal(a.numpy(), b)

    def test_it_takes_the_strided_planes_of_a_yuv_file(self, tmp_path):
        frames = np.random.default_rng(3).integers(
            0, 255, size=(6, 48, 64, 3), dtype=np.uint8)
        path = str(tmp_path / "clip.i420")
        stream.write_yuv_file(path, [(np.arange(6) / 25.0,
                                      stream.pack_yuv420(frames))])
        (_, planes), = list(stream.yuv_file_batches(path, 48, 64, 6))
        out = stream._Shipper(torch.device("cpu"), 1).take(
            stream._Shipper(torch.device("cpu"), 1).put(planes))
        for a, b in zip(out, stream.pack_yuv420(frames)):
            np.testing.assert_array_equal(a.numpy(), b)


# -- accounting ----------------------------------------------------------------


class TestAccounting:
    def test_isolate_legs(self):
        batches = _batches(2)
        legs = stream.isolate_legs(
            batches, lambda c, ts, y, u, v: (c, y.to(torch.float32).sum()),
            None, device="cpu")
        jlegs = jstream.isolate_legs(
            batches, lambda c, ts, y, u, v: (c, jnp.sum(y.astype(jnp.float32))),
            None)
        assert set(legs) == set(jlegs)
        assert legs["transfer_fps"] > 0 and legs["transfer_gbps"] >= 0
        assert legs["compute_fps"] > 0 and legs["pack_fps"] > 0

    def test_isolate_legs_prepacked(self):
        packed = [(ts, stream.pack_yuv420(f)) for ts, f in _batches(2)]
        legs = stream.isolate_legs(
            packed, lambda c, ts, y, u, v: (c, y.to(torch.float32).sum()),
            None, pack=False, device="cpu")
        assert legs["pack_fps"] is None and legs["compute_fps"] > 0

    @pytest.mark.parametrize("wall,legs", [
        (3.0, [3.0, 1.0, 1.0]), (5.0, [3.0, 1.0, 1.0]), (4.0, [3.0, 1.0, 1.0]),
        (10.0, []), (2.0, [2.0]), (1.0, [3.0, 1.0]), (9.0, [3.0, 1.0, 0.0]),
        (0.7, [0.5, 0.4, 0.0, 0.3])])
    def test_pipelining_efficiency(self, wall, legs):
        out = stream.pipelining_efficiency(wall, legs)
        assert out == jstream.pipelining_efficiency(wall, legs)
        assert 0.0 <= out <= 1.0

    @pytest.mark.parametrize("args", [
        (1280 * 720 * 1.5, 500.0, 12.0), (1280 * 720 * 1.5, 500.0, 0.047),
        (1280 * 720 * 1.5, 500.0, 12.0, 80.0), (160 * 120 * 1.5, 90.0, 25.0, None)])
    def test_project_fps(self, args):
        assert stream.project_fps(*args) == jstream.project_fps(*args)

    def test_stream_stats_against_jax(self):
        fields = dict(frames=640, batches=10, bytes_shipped=884_736_000,
                      decode_s=1.23456, pack_s=2.5, transfer_s=0.75,
                      feed_wait_s=0.125, compute_s=3.0625, wall_s=4.5)
        out, ref = stream.StreamStats(**fields), jstream.StreamStats(**fields)
        assert out.as_dict() == ref.as_dict()
        assert out.fps == ref.fps and out.transfer_gbps == ref.transfer_gbps
        out.legs, ref.legs = {"pack_s": 1.0}, {"pack_s": 1.0}
        assert out.as_dict() == ref.as_dict()
        assert stream.StreamStats().fps == 0.0
        assert stream.StreamStats().as_dict() == jstream.StreamStats().as_dict()


class TestYUVFileSource:
    @pytest.mark.parametrize("drop_last", [True, False])
    def test_write_read_roundtrip(self, tmp_path, drop_last):
        rng = np.random.default_rng(3)
        frames = rng.integers(0, 255, size=(10, 48, 64, 3), dtype=np.uint8)
        planes = color.rgb_to_yuv420(frames)
        src = [(np.arange(4) / 25.0, tuple(p[:4] for p in planes)),
               (np.arange(4, 10) / 25.0, tuple(p[4:] for p in planes))]
        path, jpath = str(tmp_path / "clip.i420"), str(tmp_path / "jclip.i420")
        assert stream.write_yuv_file(path, src) == 10
        assert jstream.write_yuv_file(jpath, src) == 10
        assert open(path, "rb").read() == open(jpath, "rb").read()

        got = list(stream.yuv_file_batches(path, 48, 64, 4, drop_last=drop_last))
        ref = list(jstream.yuv_file_batches(jpath, 48, 64, 4, drop_last=drop_last))
        assert len(got) == len(ref) == (2 if drop_last else 3)
        for (ts, yuv), (ts_r, yuv_r) in zip(got, ref):
            np.testing.assert_allclose(ts, ts_r)
            for a, b in zip(yuv, yuv_r):
                np.testing.assert_array_equal(a, b)
        ts, (y, u, v) = got[1]
        assert y.shape == (4, 48, 64) and u.shape == (4, 24, 32)
        np.testing.assert_array_equal(y, planes[0][4:8])
        np.testing.assert_array_equal(v, planes[2][4:8])
        if not drop_last:
            assert got[-1][1][0].shape[0] == 2


# -- io/batch.py ---------------------------------------------------------------


class TestBatch:
    @pytest.mark.parametrize("size", [1, 2, 8])
    def test_prefetch_to_device_keeps_order_and_content(self, size):
        items = _batches(5)
        out = list(batch.prefetch_to_device(iter(items), size=size, device="cpu"))
        assert len(out) == len(items)
        for (ts, frames), (ts_d, frames_d) in zip(items, out):
            assert isinstance(frames_d, torch.Tensor) and frames_d.dtype == torch.uint8
            np.testing.assert_array_equal(frames_d.numpy(), frames)
            np.testing.assert_array_equal(ts_d.numpy(), ts)

    def test_prefetch_runs_ahead_by_its_size(self):
        pulled = []

        def source():
            for i in range(6):
                pulled.append(i)
                yield np.full((2,), i)

        it = batch.prefetch_to_device(source(), size=3, device="cpu")
        assert pulled == []          # nothing is read before the first item
        first = next(it)
        assert int(first[0]) == 0 and pulled == [0, 1, 2, 3]
        assert [int(x[0]) for x in it] == [1, 2, 3, 4, 5]

    def test_prefetch_maps_nested_items_and_passes_others_through(self):
        item = {"a": np.ones(3), "b": [np.zeros(2), "label"], "c": 7}
        out, = list(batch.prefetch_to_device([item], device="cpu"))
        assert isinstance(out["a"], torch.Tensor)
        assert isinstance(out["b"][0], torch.Tensor) and out["b"][1] == "label"
        assert out["c"] == 7

    def test_device_batches_against_jax(self):
        from pyannote_video_tpu import Video as JVideo
        from pyannote_video_tpu.io.batch import device_batches as jdevice_batches

        frames = np.random.default_rng(5).integers(
            0, 255, size=(10, 24, 32, 3), dtype=np.uint8)
        ref = list(jdevice_batches(JVideo(frames, fps=25.0), 4))
        out = list(batch.device_batches(Video(frames, fps=25.0), 4, device="cpu"))
        assert len(out) == len(ref) == 3
        for (ts, fr), (ts_r, fr_r) in zip(out, ref):
            np.testing.assert_allclose(np.asarray(ts), np.asarray(ts_r))
            np.testing.assert_array_equal(fr.numpy(), np.asarray(fr_r))
