"""The port's shot stage against the JAX package, on the CPU.

Same numpy-seeded inputs through the JAX function and its PyTorch
counterpart (``device="cpu"``, where the DFD wrapper takes its plain
version).  Tolerances: float32 elementwise ops 1e-4; the DFD 1e-3 (block
means summed in another order); medfilt exact (it selects, never sums).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyannote_video_tpu.ops import color as jcolor
from pyannote_video_tpu.ops.dfd import dfd_series as jax_dfd
from pyannote_video_tpu.ops.medfilt import medfilt1d as jax_medfilt
from pyannote_video_tpu.utils.synthetic import synthetic_episode

from pyannote_video_tpu_torch.ops import color
from pyannote_video_tpu_torch.ops.dfd import dfd_series, dfd_series_plain
from pyannote_video_tpu_torch.ops.medfilt import medfilt1d


def _segments(shots):
    return [(s.start, s.end) for s in shots]


class TestColor:
    def test_to_gray(self):
        x = np.random.default_rng(0).integers(0, 256, (3, 7, 9, 3), dtype=np.uint8)
        ref = np.asarray(jcolor.to_gray(jnp.asarray(x)))
        out = color.to_gray(torch.from_numpy(x)).numpy()
        assert out.dtype == np.float32
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)

    @pytest.mark.parametrize("shape,out_hw", [((2, 30, 41), (11, 17)),
                                              ((2, 12, 16, 3), (25, 7))])
    def test_resize_bilinear(self, shape, out_hw):
        x = np.random.default_rng(1).uniform(0, 255, shape).astype(np.float32)
        ref = np.asarray(jcolor.resize_bilinear(jnp.asarray(x), *out_hw))
        out = color.resize_bilinear(torch.from_numpy(x), *out_hw).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)

    def test_ingest_gray(self):
        x = np.random.default_rng(2).integers(0, 256, (3, 72, 96, 3), dtype=np.uint8)
        ref = np.asarray(jcolor.ingest_gray(jnp.asarray(x), 50, 67))
        out = color.ingest_gray(torch.from_numpy(x), 50, 67).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


class TestMedfilt:
    @pytest.mark.parametrize("mode", ["zero", "reflect"])
    @pytest.mark.parametrize("n,k", [(40, 7), (3, 9)])
    def test_matches_jax(self, mode, n, k):
        y = np.random.default_rng(n).uniform(0, 10, n).astype(np.float32)
        ref = np.asarray(jax_medfilt(jnp.asarray(y), k, mode=mode))
        out = medfilt1d(torch.from_numpy(y), k, mode=mode).numpy()
        np.testing.assert_array_equal(out, ref)


class TestDFD:
    @pytest.mark.parametrize("subpixel", [True, False])
    @pytest.mark.parametrize("shape", [(12, 40, 60), (6, 50, 88)])
    def test_plain_matches_jax(self, shape, subpixel):
        g = np.random.default_rng(3).uniform(0, 255, shape).astype(np.float32)
        ref = np.asarray(jax_dfd(jnp.asarray(g), subpixel=subpixel))
        out = dfd_series_plain(torch.from_numpy(g), subpixel=subpixel).numpy()
        assert out.shape == (shape[0] - 1,)
        np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)

    @pytest.mark.slow
    def test_plain_matches_pallas_interpret(self):
        """The TPU kernel itself, through the Pallas interpreter, as
        tests/test_pallas.py runs it."""
        import unittest.mock as mock

        from jax.experimental import pallas as pl
        from pyannote_video_tpu.ops import dfd_pallas

        g = np.random.default_rng(4).uniform(0, 255, (6, 50, 88)).astype(np.float32)
        orig = pl.pallas_call

        def interp_call(*args, **kwargs):
            kwargs["interpret"] = True
            return orig(*args, **kwargs)

        with mock.patch.object(dfd_pallas.pl, "pallas_call", side_effect=interp_call):
            ref = np.asarray(dfd_pallas.dfd_series_pallas.__wrapped__(jnp.asarray(g)))
        out = dfd_series_plain(torch.from_numpy(g)).numpy()
        # the Pallas kernel pools with matmuls: same drift bound as test_pallas
        np.testing.assert_allclose(out, ref, rtol=5e-3, atol=0.2)

    def test_cpu_tensor_takes_plain_path(self):
        g = torch.from_numpy(
            np.random.default_rng(5).uniform(0, 255, (5, 20, 23)).astype(np.float32))
        before = dfd_series.launches
        out = dfd_series(g)
        assert dfd_series.launches == before   # no kernel launch on the CPU
        torch.testing.assert_close(out, dfd_series_plain(g), rtol=0, atol=0)

    @pytest.mark.parametrize("bad", [np.zeros((1, 10, 10), np.float32),
                                     np.zeros((4, 10, 10), np.float64),
                                     np.zeros((4, 3, 10), np.float32)])
    def test_rejects_bad_input(self, bad):
        with pytest.raises(ValueError):
            dfd_series(torch.from_numpy(bad))


class TestShot:
    @pytest.fixture(scope="class")
    def episode(self):
        return synthetic_episode(n_shots=4, shot_frames=32, width=160,
                                 height=120, seed=7)

    @pytest.mark.parametrize("batch_size", [256, 16])
    def test_boundaries_match_jax(self, episode, batch_size):
        from pyannote_video_tpu import Video as JVideo
        from pyannote_video_tpu.pipeline.shot import Shot as JShot

        from pyannote_video_tpu_torch.io.video import Video
        from pyannote_video_tpu_torch.pipeline.shot import Shot

        for threshold in (2.0, 1.0):
            ref = JShot(JVideo(episode.frames, fps=episode.fps),
                        threshold=threshold, batch_size=batch_size)
            out = Shot(Video(episode.frames, fps=episode.fps),
                       threshold=threshold, batch_size=batch_size, device="cpu")
            assert _segments(out) == _segments(ref)
        # cuts at frames 32/64/96: with 16-frame chunks each cut pair spans
        # a chunk edge and is found only through the carried frame
        found = [s.end for s in Shot(Video(episode.frames, fps=episode.fps),
                                     threshold=2.0, batch_size=batch_size,
                                     device="cpu")][:-1]
        assert len(found) == len(episode.cuts)
        for expected, got in zip(episode.cuts, found):
            assert abs(expected - got) <= 1.5 / episode.fps

    def test_farneback_not_ported(self, episode):
        from pyannote_video_tpu_torch.io.video import Video
        from pyannote_video_tpu_torch.pipeline.shot import Shot

        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Shot(Video(episode.frames, fps=episode.fps), method="farneback",
                 device="cpu")


class TestStructureCLI:
    def test_shot_json_byte_identical(self, tmp_path):
        pytest.importorskip("cv2")
        from pyannote_video_tpu.cli.structure_cli import main as jax_main
        from pyannote_video_tpu.utils.synthetic import write_synthetic_video

        from pyannote_video_tpu_torch.cli.structure_cli import main

        ep = synthetic_episode(n_shots=3, shot_frames=20, width=128, height=96,
                               seed=11)
        avi = str(tmp_path / "clip.avi")
        write_synthetic_video(avi, ep)
        jax_main(["shot", avi, str(tmp_path / "jax.json")])
        main(["shot", avi, str(tmp_path / "torch.json")], device="cpu")
        ref = (tmp_path / "jax.json").read_bytes()
        assert (tmp_path / "torch.json").read_bytes() == ref
        assert ref.startswith(b'{"pyannote": "Timeline"')

    @pytest.mark.parametrize("argv", [["thread", "v.avi", "s.json", "o.json"],
                                      ["scene", "v.avi", "t.json", "o.json"]])
    def test_unported_commands_exit_nonzero(self, argv):
        from pyannote_video_tpu_torch.cli.structure_cli import main

        with pytest.raises(SystemExit) as exc:
            main(argv, device="cpu")
        assert exc.value.code not in (0, None)
        assert "not ported" in str(exc.value.code)
