"""The port's DSST tracker against the JAX package, on the CPU.

Same numpy-seeded inputs through both.  What is held exactly: the matcher
(element for element) and, in a scan, the status, uid and detection
columns.  What is held within a tolerance: everything that passes through
an FFT, since torch's and JAX's CPU FFTs round differently in float32 —
filter fields to 1e-3 of the field's largest magnitude, PSR to rtol 1e-2,
positions to 1e-3 px after one step and 0.05 px over a scan.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyannote_video_tpu.core.assignment import associate_by_overlap
from pyannote_video_tpu.ops import dsst as jdsst
from pyannote_video_tpu.ops.warp import transpose_for_chips

from pyannote_video_tpu_torch.ops import dsst
from pyannote_video_tpu_torch.ops.color import resize_bilinear

N_SLOTS = 16
H, W = 120, 160


def _draw(img, cy, cx, size, seed):
    """A textured square drawn into ``img``; returns its box."""
    rng = np.random.default_rng(seed)
    tex = rng.uniform(50, 200, (64, 64)).astype(np.float32)
    tex[16:48, 16:48] += 55.0
    patch = resize_bilinear(torch.from_numpy(tex)[None], size, size)[0].numpy()
    y0, x0 = int(round(cy - size / 2)), int(round(cx - size / 2))
    img[y0:y0 + size, x0:x0 + size] = patch
    return (x0, y0, x0 + size, y0 + size)


# still objects beside the moving target: (cy, cx, size)
BYSTANDERS = [(100, 20, 18), (100, 45, 18), (100, 70, 18), (100, 95, 18),
              (100, 120, 18)]


def _scene(cy=60.0, cx=80.0, size=32, bystanders=0):
    """A textured square (the target) on a flat background, and
    ``bystanders`` still ones along the bottom edge."""
    img = np.full((H, W), 30.0, dtype=np.float32)
    for k in range(bystanders):
        _draw(img, *BYSTANDERS[k], seed=100 + k)
    return img, _draw(img, cy, cx, size, seed=42)


def _bystander_box(k):
    cy, cx, size = BYSTANDERS[k]
    return (cx - size // 2, cy - size // 2, cx + size // 2, cy + size // 2)


def _episode(kind, T=16, bystanders=0):
    """Frames [T, H, W] and the target's box per frame."""
    frames, boxes = [], []
    for t in range(T):
        if kind == "translate":
            img, box = _scene(cy=40 + 1.5 * t, cx=100 - 2.0 * t,
                              bystanders=bystanders)
        else:
            img, box = _scene(cy=50.0, size=int(round(28 * 1.03 ** t)),
                              bystanders=bystanders)
        frames.append(img)
        boxes.append(box)
    return np.stack(frames), np.asarray(boxes, np.float32)


def _jax_state_np(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def _slot_inputs():
    """Two frames, per-slot boxes for 3 live slots of 16."""
    f0, box0 = _scene()
    f1, _ = _scene(cy=62.0, cx=77.0)
    grays = np.stack([f0, f1])
    boxes = np.tile(np.asarray([[10, 10, 30, 30]], np.float32), (N_SLOTS, 1))
    boxes[0] = box0
    boxes[3] = [20.5, 30.25, 70.0, 90.75]
    boxes[7] = [100, 5, 150, 60]
    mask = np.zeros((N_SLOTS,), bool)
    mask[[0, 3, 7]] = True
    return grays, boxes, mask


def _jax_restart(grays, boxes, mask):
    imT = transpose_for_chips(jnp.asarray(grays)[..., None])
    return jdsst.restart_slots(
        jdsst.init_state(N_SLOTS), imT, H, W,
        jnp.zeros((N_SLOTS,), jnp.int32), jnp.asarray(boxes),
        jnp.asarray(mask)), imT


def _assert_states_close(out, ref, rtol_of_max=1e-3, pos_atol=1e-3):
    """``out``: the port's TrackState; ``ref``: field → numpy (JAX)."""
    for name, want in ref.items():
        got = getattr(out, name).numpy()
        if name == "alive":
            np.testing.assert_array_equal(got, want)
        elif name in ("pos", "size"):
            np.testing.assert_allclose(got, want, atol=pos_atol, rtol=0,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(
                got, want, atol=rtol_of_max * np.abs(want).max(), rtol=0,
                err_msg=name)


class TestTables:
    @pytest.mark.parametrize("name", ["_hann2d", "_gaussian_target_fft",
                                      "_scale_factors", "_scale_target_fft",
                                      "_scale_hann"])
    def test_constant_tables(self, name):
        ref = np.asarray(getattr(jdsst, name)())
        out = getattr(dsst, name)().numpy()
        assert out.shape == ref.shape
        # 1e-5 of the table's largest magnitude (the target FFTs reach ~100)
        np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(),
                                   rtol=0)

    def test_tables_are_cached_per_device(self):
        dev = torch.device("cpu")
        assert dsst._tables(dev) is dsst._tables(dev)
        assert dsst._match_tables(8, dev) is dsst._match_tables(8, dev)


class TestState:
    def test_state_round_trip(self):
        rng = np.random.default_rng(0)
        ref = {k: rng.normal(size=v.shape).astype(np.float32)
               for k, v in _jax_state_np(jdsst.init_state(4)).items()}
        ref["alive"] = np.asarray([True, False, True, False])
        back = dsst.state_to_numpy(dsst.state_from_jax(ref))
        assert list(back) == list(dsst.TrackState._fields)
        for k in ref:
            np.testing.assert_array_equal(back[k], ref[k])

    def test_init_state_matches_jax(self):
        ref = _jax_state_np(jdsst.init_state(N_SLOTS))
        out = dsst.state_to_numpy(dsst.init_state(N_SLOTS))
        for k in ref:
            assert out[k].dtype == ref[k].dtype and out[k].shape == ref[k].shape
            np.testing.assert_array_equal(out[k], ref[k])

    def test_restart_slots_matches_jax(self):
        grays, boxes, mask = _slot_inputs()
        ref, _ = _jax_restart(grays, boxes, mask)
        out = dsst.restart_slots(
            dsst.init_state(N_SLOTS), torch.from_numpy(grays),
            torch.zeros((N_SLOTS,), dtype=torch.long),
            torch.from_numpy(boxes), torch.from_numpy(mask))
        _assert_states_close(out, _jax_state_np(ref))

    def test_start_tracks_matches_jax(self):
        grays, boxes, _ = _slot_inputs()
        det = boxes[[0, 3, 7, 1]]
        slots = np.asarray([2, 5, 1, 9], np.int32)
        mask = np.asarray([True, True, True, False])   # a padding row
        ref = jdsst.start_tracks(
            jdsst.init_state(N_SLOTS), jnp.asarray(grays[0]),
            jnp.asarray(det), jnp.asarray(slots), jnp.asarray(mask))
        out = dsst.start_tracks(
            dsst.init_state(N_SLOTS), torch.from_numpy(grays[0]),
            torch.from_numpy(det), torch.from_numpy(slots),
            torch.from_numpy(mask))
        _assert_states_close(out, _jax_state_np(ref))
        assert out.alive.numpy().tolist() == [
            s in (1, 2, 5) for s in range(N_SLOTS)]


class TestStep:
    def test_one_step_from_a_jax_state(self):
        """One ``_step_core`` in both packages from the same state."""
        grays, boxes, mask = _slot_inputs()
        state_j, imT = _jax_restart(grays, boxes, mask)
        slot_frame = np.ones((N_SLOTS,), np.int32)
        step_j = jax.jit(jdsst._step_core, static_argnums=(2, 3))
        ref_state, ref_boxes, ref_conf = step_j(
            state_j, imT, H, W, jnp.asarray(slot_frame), 10.0)

        state_t = dsst.state_from_jax(_jax_state_np(state_j))
        out_state, out_boxes, out_conf = dsst._step_core(
            state_t, torch.from_numpy(grays),
            torch.from_numpy(slot_frame).long(), 10.0)

        _assert_states_close(out_state, _jax_state_np(ref_state))
        np.testing.assert_allclose(out_boxes.numpy(), np.asarray(ref_boxes),
                                   atol=1e-3, rtol=0)
        ref_conf = np.asarray(ref_conf)
        live = np.isfinite(ref_conf)
        assert live.tolist() == mask.tolist()
        np.testing.assert_array_equal(np.isfinite(out_conf.numpy()), live)
        np.testing.assert_allclose(out_conf.numpy()[live], ref_conf[live],
                                   rtol=1e-2)
        # the step moved the tracked target: slot 0 follows (+2, -3)
        assert abs(out_state.pos[0, 0].item() - 62.0) < 1.5
        assert abs(out_state.pos[0, 1].item() - 77.0) < 1.5

    def test_track_scan_equals_stepping(self):
        frames, boxes = _episode("translate", T=6)
        state = dsst.start_tracks(
            dsst.init_state(2), torch.from_numpy(frames[0]),
            torch.from_numpy(boxes[:1]), torch.tensor([0]),
            torch.tensor([True]))
        final, sboxes, sconfs, alive = dsst.track_scan(
            state, torch.from_numpy(frames[1:]), 5.0)
        assert sboxes.shape == (5, 2, 4) and alive.dtype == torch.bool
        it = state
        for t in range(1, 6):
            assert alive[t - 1].tolist() == it.alive.tolist()
            it, b, c = dsst.step(it, torch.from_numpy(frames[t]), 5.0)
            torch.testing.assert_close(sboxes[t - 1], b, rtol=0, atol=0)
            torch.testing.assert_close(sconfs[t - 1], c, rtol=0, atol=0)
        torch.testing.assert_close(final.pos, it.pos, rtol=0, atol=0)
        # and the tracker followed the target
        want = (boxes[5, :2] + boxes[5, 2:]) / 2
        got = (sboxes[-1, 0, :2] + sboxes[-1, 0, 2:]).numpy() / 2
        assert np.abs(got - want).max() < 2.0


@functools.lru_cache(maxsize=None)
def _jax_match(n, d):
    return jax.jit(jdsst._optimal_match)


def _match_both(ov):
    ov = np.asarray(ov, np.float32)
    ref = np.asarray(_jax_match(*ov.shape)(jnp.asarray(ov)))
    out = dsst._optimal_match(torch.from_numpy(ov)).numpy()
    return out, ref


def _pairs(match_slot):
    return sorted((int(n), d) for d, n in enumerate(match_slot) if n >= 0)


def _host_pairs(ov):
    n_t, n_d = ov.shape
    n = max(n_t, n_d)
    padded = np.zeros((n, n))
    padded[:n_t, :n_d] = ov
    return sorted(associate_by_overlap(padded, n_t, n_d))


# the tie patterns of tests/test_warp_dsst.py::TestAssociation
ASSOCIATION_PATTERNS = {
    "crossing_near_tie": [[0.50, 0.45], [0.40, 0.00]],
    "symmetric_near_tie": [[0.51, 0.49], [0.49, 0.51]],
    "exact_tie": [[0.5, 0.5], [0.5, 0.5]],
    "contained": [[0.9, 0.2], [0.85, 0.0]],
    "chain": [[0.6, 0.0, 0.0], [0.7, 0.5, 0.0], [0.0, 0.6, 0.4]],
    "all_zero": np.zeros((3, 2)),
    "single_pair": [[0.3]],
    "tied_detections": [[0.4, 0.4, 0.4]],
    "tied_trackers": [[0.4], [0.4], [0.4]],
}


class TestAssociation:
    @pytest.mark.parametrize("n_slots", [4, 16])
    def test_optimal_match_equals_jax_on_random_gated_matrices(self, n_slots):
        rng = np.random.default_rng(17 + n_slots)
        for trial in range(110):
            ov = rng.uniform(0.0, 1.0, size=(n_slots, 8)).astype(np.float32)
            ov[rng.uniform(size=ov.shape) < 0.5] = 0.0
            if trial % 5 == 0:            # ties: a few repeated values
                ov = np.round(ov * 4) / 4
            out, ref = _match_both(ov)
            np.testing.assert_array_equal(out, ref, err_msg=str((trial, ov)))

    @pytest.mark.parametrize("name", sorted(ASSOCIATION_PATTERNS))
    def test_optimal_match_equals_jax_on_tie_patterns(self, name):
        ov = np.asarray(ASSOCIATION_PATTERNS[name], np.float32)
        out, ref = _match_both(ov)
        np.testing.assert_array_equal(out, ref)
        pairs = _pairs(out)
        assert all(ov[t, d] > 0 for t, d in pairs)   # no zero-overlap match
        host = _host_pairs(ov)
        assert abs(sum(ov[t, d] for t, d in pairs)
                   - sum(ov[t, d] for t, d in host)) < 1e-6

    def test_crossing_near_tie_beats_greedy(self):
        out, _ = _match_both(ASSOCIATION_PATTERNS["crossing_near_tie"])
        assert _pairs(out) == [(0, 1), (1, 0)]

    def test_unmatched_detection_does_not_touch_the_last_slot(self):
        """d = -1 in the backtrack must not write ``match_slot[-1]``."""
        ov = np.zeros((16, 8), np.float32)
        ov[3, 2] = 0.7
        out, ref = _match_both(ov)
        np.testing.assert_array_equal(out, ref)
        assert out[2] == 3 and (np.delete(out, 2) == -1).all()

    @pytest.mark.parametrize("shape", [(16, 16), (7, 16), (20, 13)])
    def test_jv_match_total_equals_hungarian(self, shape):
        rng = np.random.default_rng(23 + shape[0])
        for trial in range(3):
            ov = rng.uniform(0.0, 1.0, size=shape)
            ov[rng.uniform(size=shape) < 0.6] = 0.0
            out = dsst._optimal_match(torch.from_numpy(ov.astype(np.float32)))
            pairs = _pairs(out.numpy())
            host = _host_pairs(ov)
            assert all(ov[t, d] > 0 for t, d in pairs)
            assert abs(sum(ov[t, d] for t, d in pairs)
                       - sum(ov[t, d] for t, d in host)) < 1e-5
            # continuous random values: the optimum is unique
            assert pairs == host, (trial, pairs, host)

    def test_jv_match_equals_jax(self):
        rng = np.random.default_rng(5)
        ov = rng.uniform(0.0, 1.0, size=(16, 16)).astype(np.float32)
        ov[rng.uniform(size=ov.shape) < 0.6] = 0.0
        ref = np.asarray(jax.jit(jdsst._jv_match)(jnp.asarray(ov)))
        np.testing.assert_array_equal(
            dsst._jv_match(torch.from_numpy(ov)).numpy(), ref)


class TestShotScan:
    D = 8

    def _inputs(self, kind, T=16, extra_det=False, bystanders=0):
        frames, boxes = _episode(kind, T, max(bystanders, int(extra_det)))
        det_boxes = np.zeros((T, self.D, 4), np.float32)
        det_valid = np.zeros((T, self.D), bool)
        for t in range(0, T, 5):
            det_boxes[t, 0] = boxes[t]
            det_valid[t, 0] = True
        if extra_det:
            # a second, still object detected once, and a contained
            # duplicate of the target at frame 5
            det_boxes[0, 1] = _bystander_box(0)
            det_valid[0, 1] = True
            x0, y0, x1, y1 = boxes[5]
            det_boxes[5, 1] = [x0 + 6, y0 + 6, x1 - 6, y1 - 6]
            det_valid[5, 1] = True
        return frames, det_boxes, det_valid

    def _run_both(self, frames, frame_valid, det_boxes, det_valid, n=N_SLOTS):
        (_, uid_j, next_j), packed_j, dropped_j = jdsst.shot_scan_jit(
            jdsst.init_state(n), jnp.full((n,), -1, jnp.int32), jnp.int32(0),
            jnp.asarray(frames), jnp.asarray(frame_valid),
            jnp.asarray(det_boxes), jnp.asarray(det_valid), 10.0, 0.3, 0.6)
        (_, uid_t, next_t), packed_t, dropped_t = dsst.shot_scan(
            dsst.init_state(n), torch.full((n,), -1), 0,
            torch.from_numpy(frames), frame_valid, det_boxes, det_valid,
            10.0, 0.3, 0.6)
        assert int(next_t) == int(next_j)
        np.testing.assert_array_equal(uid_t.numpy(), np.asarray(uid_j))
        np.testing.assert_array_equal(dropped_t.numpy(), np.asarray(dropped_j))
        return packed_t.numpy(), np.asarray(packed_j)

    def _assert_packed(self, out, ref):
        assert out.shape == ref.shape
        for col in (dsst.PACK_STATUS, dsst.PACK_UID, dsst.PACK_DET):
            np.testing.assert_array_equal(out[..., col], ref[..., col])
        live = ref[..., dsst.PACK_STATUS] > 0
        np.testing.assert_allclose(out[..., dsst.PACK_BOX][live],
                                   ref[..., dsst.PACK_BOX][live],
                                   atol=0.05, rtol=0)
        conf = np.isfinite(ref[..., dsst.PACK_CONF])
        np.testing.assert_array_equal(np.isfinite(out[..., dsst.PACK_CONF]), conf)
        np.testing.assert_allclose(out[..., dsst.PACK_CONF][conf & live],
                                   ref[..., dsst.PACK_CONF][conf & live],
                                   rtol=1e-2)

    @pytest.mark.parametrize("kind", ["translate", "zoom"])
    def test_packed_output_matches_jax(self, kind):
        frames, det_boxes, det_valid = self._inputs(kind, extra_det=True)
        T = len(frames)
        out, ref = self._run_both(frames, np.ones((T,), bool), det_boxes,
                                  det_valid)
        self._assert_packed(out, ref)
        status = out[:, :, dsst.PACK_STATUS]
        # the target keeps slot 0: re-seeded at every detection frame,
        # followed in between (the zoom's size steps cost it two frames)
        assert (status[[0, 5, 10, 15], 0] == 2).all()
        tracked = status[:, 0] > 0
        assert tracked.sum() >= T - 2
        truth = _episode(kind, T, 1)[1]
        got = out[:, 0, dsst.PACK_BOX]
        size = truth[:, 2] - truth[:, 0]
        assert (np.abs(got - truth).max(axis=1) < 0.15 * size)[tracked].all()

    def test_padded_frames_are_skipped(self):
        """The JAX caller's padded call: trailing invalid frames."""
        frames, det_boxes, det_valid = self._inputs("translate", T=16)
        frame_valid = np.ones((16,), bool)
        frame_valid[11:] = False
        out, ref = self._run_both(frames, frame_valid, det_boxes, det_valid)
        self._assert_packed(out, ref)
        assert not out[11:].any()

    def test_dropped_counts_match_jax(self):
        """More detections than slots: the overflow is counted, not lost
        silently."""
        frames, det_boxes, det_valid = self._inputs("translate", T=6,
                                                    bystanders=5)
        for k in range(5):
            det_boxes[0, k + 1] = _bystander_box(k)
            det_valid[0, k + 1] = True
        out, ref = self._run_both(frames, np.ones((6,), bool), det_boxes,
                                  det_valid, n=4)
        self._assert_packed(out, ref)
        assert (out[0, :, dsst.PACK_STATUS] == 2).all()   # 4 slots, 6 boxes

    def test_reversed_frame_index_equals_flipped_stack(self):
        frames, det_boxes, det_valid = self._inputs("translate", T=11)
        order = np.arange(10, -1, -1)
        args = (np.ones((11,), bool), det_boxes[order], det_valid[order],
                10.0, 0.3, 0.6)
        _, flipped, _ = dsst.shot_scan(
            dsst.init_state(N_SLOTS), torch.full((N_SLOTS,), -1), 0,
            torch.from_numpy(frames[order].copy()), *args)
        _, indexed, _ = dsst.shot_scan(
            dsst.init_state(N_SLOTS), torch.full((N_SLOTS,), -1), 0,
            torch.from_numpy(frames), *args, frame_index=order)
        torch.testing.assert_close(indexed, flipped, rtol=0, atol=0)
