"""What surrounds the port's DFD kernel, on the CPU: its launch plan, the
plan's tile-by-tile arithmetic, and the shot stage at a height whose frames
no longer fit one CTA's shared memory whole.

The kernel (``csrc/dfd.cu``) runs only on the card; here the plan that cuts
its launches is checked for every height the CLI can ask for, and a plain
evaluation that follows the plan tile by tile (the kernel's staging, edge
clamps and fixed-order sums) is held to the whole-frame plain version
(atol 1e-4: the same float32 block means, summed in another order) and to
the JAX package (atol 1e-3, as in ``tests/test_torch_shot.py``).  The
pairwise form ``dfd_pairs_reference_style`` is held to JAX's (atol 1e-3)
and to the series of each pair on its own.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyannote_video_tpu.ops.dfd import dfd_pairs_reference_style as jax_pairs
from pyannote_video_tpu.ops.dfd import dfd_series as jax_dfd
from pyannote_video_tpu.utils.synthetic import synthetic_episode

from pyannote_video_tpu_torch.ops import dfd as D

MAX_SMEM = 232448   # bytes of shared memory one CTA may use on Hopper


def _out_w(height: int, w: int, h: int, block: int = 5) -> int:
    """``Shot``'s output width for a ``w``×``h`` video (pipeline/shot.py)."""
    return max(block, int(round(w * height / h)))


def _check_plan(plan: D.Plan) -> None:
    T, H, W, r, B = plan.T, plan.H, plan.W, plan.radius, plan.block
    n_by, n_bx = H // B, W // B
    # shared memory far under a CTA's 227 KB, static shared memory counted
    assert plan.smem <= D._SMEM_BUDGET
    assert D._SMEM_BUDGET + D._STATIC_SMEM < MAX_SMEM
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= D._MAX_THREADS
    assert plan.pairs * plan.band * plan.tile_bx <= plan.threads
    # every pair once, in groups of `pairs`
    assert sum(min(plan.pairs, T - 1 - g * plan.pairs)
               for g in range(plan.n_groups)) == T - 1
    # every block once
    seen = np.zeros((n_by, n_bx), np.int32)
    for t in range(plan.n_tiles):
        by0, bx0 = plan.tile(t)
        seen[by0:by0 + plan.band, bx0:bx0 + plan.tile_bx] += 1
        # the rows the windows read, edge-clamped, are the rows staged
        y_org = by0 * B - r
        assert plan.window_rows(t) == [min(max(y_org + a, 0), H - 1)
                                       for a in range(plan.rows)]
        assert set(plan.window_rows(t)) == set(plan.staged_rows(t))
        assert set(plan.window_cols(t)) <= set(plan.staged_cols(t))
        n_rows, n_cols = len(plan.staged_rows(t)), len(plan.staged_cols(t))
        # a copy spans up to 3 floats either side of its data
        if plan.full:
            assert plan.n_tx == 1 and n_cols == W
            assert D._PAD + n_rows * W + 6 <= plan.fstride
        else:
            assert set(plan.window_cols(t)) == set(plan.staged_cols(t))
            assert plan.pitch >= n_cols + 6 and plan.pitch % 4 == W % 4
            assert D._PAD + 3 + n_rows * plan.pitch <= plan.fstride
    assert (seen == 1).all()
    assert plan.fstride % 4 == 0 and plan.smem == 4 * (plan.pairs + 1) * plan.fstride


@pytest.mark.parametrize("T", [2, 65, 257])
@pytest.mark.parametrize("aspect", [(1280, 720), (640, 480)], ids=["16:9", "4:3"])
def test_plan_every_height(aspect, T):
    for height in range(36, 289):
        _check_plan(D._plan(T, height, _out_w(height, *aspect)))


def test_plan_shot_chunk_fills_the_card():
    plan = D._plan(257, 50, 89)
    assert plan.full and plan.n_tiles == 1
    assert plan.grid >= 1.9 * D._H100_SMS       # ~2 CTAs per SM


@pytest.mark.parametrize("shape,radius,block", [
    ((257, 1080, 1920), 3, 5), ((65, 2160, 3840), 3, 5), ((257, 1000, 5), 3, 5),
    ((257, 5, 1000), 3, 5), ((33, 50, 89), 2, 4), ((33, 300, 300), 7, 16),
])
def test_plan_large_and_odd_frames(shape, radius, block):
    _check_plan(D._plan(*shape, radius, block))


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        D._plan(257, 50, 89, radius=8, block=5)      # beyond the run-time instance
    with pytest.raises(ValueError):
        D._plan(70000, 200, 200)                      # 32-bit indices


def dfd_by_plan(gray: torch.Tensor, plan: D.Plan, subpixel: bool) -> torch.Tensor:
    """``dfd_series_plain`` evaluated as the kernel cuts it: per pair group
    and tile, ``pairs + 1`` frames staged through the plan's edge-clamped
    rows and columns, block minima over the tile, a sum per (pair, tile),
    then the tile sums added in tile order."""
    T, H, W = gray.shape
    r, B = plan.radius, plan.block
    n_by, n_bx = H // B, W // B
    hb, wb = plan.band * B, plan.tile_bx * B
    partial = torch.zeros(T - 1, plan.n_tiles, dtype=torch.float32)
    for g in range(plan.n_groups):
        p0 = g * plan.pairs
        pairs = min(plan.pairs, T - 1 - p0)
        frames = gray[p0:p0 + pairs + 1]
        for t in range(plan.n_tiles):
            by0, bx0 = plan.tile(t)
            rows = torch.tensor(plan.window_rows(t))
            cols = torch.tensor(plan.window_cols(t))
            staged = frames[:, rows][:, :, cols]          # [pairs + 1, rows, cols]
            minima = D.block_minima(staged[:-1, r:r + hb, r:r + wb],
                                    staged[1:, :hb + 2 * r, :wb + 2 * r],
                                    r, B, subpixel)         # [pairs, band, tile_bx]
            inside = ((torch.arange(plan.band) + by0 < n_by)[:, None]
                      & (torch.arange(plan.tile_bx) + bx0 < n_bx)[None, :])
            partial[p0:p0 + pairs, t] = (minima * inside).sum(dim=(1, 2))
    out = torch.zeros(T - 1, dtype=torch.float32)
    for t in range(plan.n_tiles):
        out += partial[:, t]
    return out / (n_by * n_bx)


@pytest.mark.parametrize("subpixel", [True, False])
@pytest.mark.parametrize("shape,n_sm", [((4, 144, 256), 132), ((6, 50, 89), 132),
                                        ((12, 40, 60), 1), ((3, 40, 1400), 132)],
                         ids=["144x256", "50x89", "pairs-per-cta", "column-tiles"])
def test_tiled_plain_matches_whole_frame_and_jax(shape, n_sm, subpixel):
    g = np.random.default_rng(sum(shape)).uniform(0, 255, shape).astype(np.float32)
    plan = D._plan(*shape, 3, 5, n_sm)
    out = dfd_by_plan(torch.from_numpy(g), plan, subpixel).numpy()
    whole = D.dfd_series_plain(torch.from_numpy(g), subpixel=subpixel).numpy()
    np.testing.assert_allclose(out, whole, atol=1e-4, rtol=0)
    ref = np.asarray(jax_dfd(jnp.asarray(g), subpixel=subpixel))
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)


def test_plans_in_the_tiled_test_cover_each_layout():
    assert D._plan(4, 144, 256).n_tiles > 1                       # row bands
    assert D._plan(12, 40, 60, 3, 5, 1).pairs > 1                 # pairs per CTA
    assert not D._plan(3, 40, 1400).full                          # column tiles


def test_shot_height_144_matches_jax():
    """A height whose 16:9 frames (144x256) needed more shared memory than a
    CTA has before the kernel was cut into tiles."""
    from pyannote_video_tpu import Video as JVideo
    from pyannote_video_tpu.pipeline.shot import Shot as JShot

    from pyannote_video_tpu_torch.io.video import Video
    from pyannote_video_tpu_torch.pipeline.shot import Shot

    ep = synthetic_episode(n_shots=4, shot_frames=24, width=256, height=144, seed=5)
    for threshold in (2.0, 1.0):
        ref = [(s.start, s.end) for s in JShot(JVideo(ep.frames, fps=ep.fps),
                                               height=144, threshold=threshold)]
        out = [(s.start, s.end) for s in Shot(Video(ep.frames, fps=ep.fps),
                                              height=144, threshold=threshold,
                                              device="cpu")]
        assert out == ref
    assert len(ref) >= 2


@pytest.mark.parametrize("P,H,W,radius,block", [(5, 36, 64, 3, 5),
                                                (3, 50, 89, 3, 5),
                                                (4, 40, 60, 2, 4)])
def test_dfd_pairs_reference_style_matches_jax(P, H, W, radius, block):
    rng = np.random.default_rng(P * H + W)
    prev = rng.uniform(0, 255, (P, H, W)).astype(np.float32)
    # the second frame of each pair a shifted copy of the first, plus noise
    cur = (np.roll(prev, (1, -2), axis=(1, 2))
           + rng.normal(0, 4, (P, H, W))).astype(np.float32)
    cur[-1] = rng.uniform(0, 255, (H, W))          # and one cut
    ours = D.dfd_pairs_reference_style(torch.from_numpy(prev),
                                       torch.from_numpy(cur), radius, block)
    ref = np.asarray(jax_pairs(jnp.asarray(prev), jnp.asarray(cur), radius, block))
    assert ours.shape == (P,)
    # arrays go to the device asked for
    assert torch.equal(D.dfd_pairs_reference_style(prev, cur, radius, block,
                                                   device="cpu"), ours)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-3)
    each = [float(D.dfd_series(torch.from_numpy(np.stack([a, b])), radius,
                               block)[0]) for a, b in zip(prev, cur)]
    np.testing.assert_allclose(ours.numpy(), each, atol=1e-4)
    assert ours[-1] > 4 * ours[:-1].max()
