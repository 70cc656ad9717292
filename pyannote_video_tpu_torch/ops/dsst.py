"""Batched DSST/MOSSE correlation tracking in the Fourier domain.

Port of ``pyannote_video_tpu/ops/dsst.py``: Danelljan et al.'s
discriminative scale-space correlation filter, with ALL live trackers of a
shot in fixed slots of one state and advanced together — each video frame
is one batched FFT correlation over ``[N_slots, P, P]`` patches.

Formulation (MOSSE numerator/denominator):

    A ← (1−η)·A + η·(G ⊙ conj(F)),   B ← (1−η)·B + η·|F|²
    response = irfft2(F_z ⊙ A / (B + λ))
    confidence = peak-to-sidelobe ratio (PSR); the default kill
    threshold 10 of the reference works unchanged.

Scale space: a separate 1-D MOSSE filter over SCALE_N geometric scale
samples of the target (DSST's own design, dimensioned after fDSST); the
translation filter runs at a single scale.

Where the JAX package compiles a whole shot into one ``lax.scan``, this
port's ``shot_scan`` is a Python loop over frames that enqueues tensor
operations and never waits for the device: no ``.item()``, no boolean-mask
indexing, no shape that depends on device data.  The two ``lax.cond``s of
the JAX scan are decided on the host from ``frame_valid`` and
``det_valid``, which the caller built there.  The step thus comes in two
fixed programs (with and without detections), each of fixed shapes.

Frames are read straight from the ``[T, H, W]`` gray stack (see
``ops/warp.py``); functions that take ``imT, H, W`` in the JAX module take
``grays`` here.
"""

from __future__ import annotations

from functools import lru_cache
from types import SimpleNamespace
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .boxes import gated_overlap_t, overlap_min_ratio_t
from .warp import separable_resize_chips

P = 64                 # patch resolution (P × P)
PATCH_SCALE = 2.0      # tracked box occupies 1/PATCH_SCALE of the patch
LAMBDA = 1e-2          # regularizer
ETA = 0.025            # filter learning rate
SIGMA_FACTOR = 1.0 / 16.0  # gaussian target sigma = P * factor
PSR_WINDOW = 5         # half-size of the peak exclusion window for PSR
# --- 1-D scale filter (Danelljan's DSST scale space, fDSST dimensions) ----
SCALE_N = 17           # scale samples per frame
SCALE_STEP = 1.02      # geometric spacing: factors SCALE_STEP**(n-8)
SCALE_FEAT = 8         # each sample resized to 8×8 → 64 features
SCALE_SIGMA = 1.0      # gaussian target sigma, in scale bins
SCALE_ETA = 0.025      # scale-filter learning rate

_SCALE_DF = SCALE_FEAT * SCALE_FEAT
_SCALE_SR = SCALE_N // 2 + 1
_SCALE_SUPER = 48      # super-patch resolution for hierarchical sampling
_STEP_SUPER = 128      # shared super-patch resolution inside _step_core
# largest relative scale sample
_SPAN = float(SCALE_STEP ** (SCALE_N // 2))


class TrackState(NamedTuple):
    """Filter state as float32 re/im pairs, field for field as in the JAX
    package, so a state carries across (``state_from_jax``).  Complex
    tensors exist only between rfft2 and irfft2 inside a step."""

    pos: torch.Tensor       # [N, 2] center (cy, cx) in frame pixels
    size: torch.Tensor      # [N, 2] (h, w) in frame pixels
    num_re: torch.Tensor    # [N, P, Pr] float32 — Re(filter numerator A)
    num_im: torch.Tensor    # [N, P, Pr] float32 — Im(A)
    den: torch.Tensor       # [N, P, Pr] float32 — filter denominator B
    s_num_re: torch.Tensor  # [N, DF, Sr] float32 — Re(scale-filter numerator)
    s_num_im: torch.Tensor  # [N, DF, Sr] float32 — Im(·)
    s_den: torch.Tensor     # [N, Sr] float32 — scale-filter denominator
    alive: torch.Tensor     # [N] bool


def _rfft_shape() -> Tuple[int, int]:
    return P, P // 2 + 1


def init_state(n_slots: int, device="cpu") -> TrackState:
    pr = _rfft_shape()[1]

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return TrackState(
        pos=zeros(n_slots, 2),
        size=torch.ones((n_slots, 2), dtype=torch.float32, device=device),
        num_re=zeros(n_slots, P, pr),
        num_im=zeros(n_slots, P, pr),
        den=zeros(n_slots, P, pr),
        s_num_re=zeros(n_slots, _SCALE_DF, _SCALE_SR),
        s_num_im=zeros(n_slots, _SCALE_DF, _SCALE_SR),
        s_den=zeros(n_slots, _SCALE_SR),
        alive=torch.zeros((n_slots,), dtype=torch.bool, device=device),
    )


def state_from_jax(fields: Dict[str, np.ndarray], device="cpu") -> TrackState:
    """A ``TrackState`` from the JAX package's state, given as a dict of
    numpy arrays by field name (``state._asdict()`` through ``np.asarray``)."""
    return TrackState(**{
        name: torch.from_numpy(np.array(fields[name])).to(device)
        for name in TrackState._fields})


def state_to_numpy(state: TrackState) -> Dict[str, np.ndarray]:
    """The inverse of ``state_from_jax``: field name → numpy array."""
    return {name: value.cpu().numpy()
            for name, value in state._asdict().items()}


# -- constant tables --------------------------------------------------------
# ``jax.jit`` folds these into the compiled program; here they are built
# once per device (on the CPU, then copied, so every device holds the same
# bits) and cached.


def _hann2d() -> torch.Tensor:
    w = 0.5 - 0.5 * torch.cos(
        2.0 * torch.pi * torch.arange(P, dtype=torch.float32) / (P - 1))
    return w[:, None] * w[None, :]


def _gaussian_target_fft() -> torch.Tensor:
    """rfft2 of a (0,0)-centred wrapped Gaussian — response peak at the
    origin means zero displacement."""
    sigma = P * SIGMA_FACTOR
    idx = torch.arange(P, dtype=torch.float32)
    d = torch.minimum(idx, P - idx)  # wrapped distance
    g = torch.exp(-0.5 * (d[:, None] ** 2 + d[None, :] ** 2) / sigma ** 2)
    return torch.fft.rfft2(g)


def _scale_factors() -> torch.Tensor:
    """Geometric scale-sample factors, index S//2 = current scale."""
    n = torch.arange(SCALE_N, dtype=torch.float32) - SCALE_N // 2
    return torch.pow(torch.tensor(SCALE_STEP, dtype=torch.float32), n)


def _scale_target_fft() -> torch.Tensor:
    """rfft of the 1-D gaussian target, peaked at the CENTER sample."""
    s = torch.arange(SCALE_N, dtype=torch.float32) - SCALE_N // 2
    return torch.fft.rfft(torch.exp(-0.5 * (s / SCALE_SIGMA) ** 2))


def _scale_hann() -> torch.Tensor:
    return 0.5 - 0.5 * torch.cos(
        2.0 * torch.pi * torch.arange(SCALE_N, dtype=torch.float32)
        / (SCALE_N - 1))


@lru_cache(maxsize=None)
def _tables(device: torch.device) -> SimpleNamespace:
    """The step's constants on ``device``."""
    tables = dict(
        hann=_hann2d(), G=_gaussian_target_fft(), factors=_scale_factors(),
        Gs=_scale_target_fft(), scale_hann=_scale_hann(),
        scale_step=torch.tensor(SCALE_STEP, dtype=torch.float32),
        freqs=torch.arange(_SCALE_SR, dtype=torch.float32),
        idx=torch.arange(P), one=torch.ones((1,), dtype=torch.float32),
    )
    return SimpleNamespace(**{k: v.to(device) for k, v in tables.items()})


@lru_cache(maxsize=None)
def _match_tables(D: int, device: torch.device) -> SimpleNamespace:
    """Subset tables of the bitmask DP over D detections."""
    masks = torch.arange(1 << D)
    bit = 1 << torch.arange(D)
    return SimpleNamespace(
        has_d=((masks[:, None] & bit[None, :]) > 0).to(device),   # [M, D]
        prev_mask=(masks[:, None] ^ bit[None, :]).to(device),     # [M, D]
        bit=bit.to(device))


# -- patch sampling ---------------------------------------------------------


def _region_matrices(left, top, sx, sy) -> torch.Tensor:
    """[..., 2, 3] axis-aligned chip → image matrices."""
    zeros = torch.zeros_like(sx)
    return torch.stack(
        [torch.stack([sx, zeros, left], dim=-1),
         torch.stack([zeros, sy, top], dim=-1)], dim=-2)


def _super_patch(grays: torch.Tensor, frame_idx: torch.Tensor,
                 pos: torch.Tensor, region: torch.Tensor,
                 res: int) -> torch.Tensor:
    """One res² patch per slot covering ``region`` (h, w) centred at pos.

    The single frame-resolution access of a hierarchical sampling scheme;
    everything that needs sub-patches of the same neighbourhood resamples
    from this.  Returns [N, res, res, 1] f32.
    """
    top = pos[:, 0] - region[:, 0] / 2.0
    left = pos[:, 1] - region[:, 1] / 2.0
    mats = _region_matrices(left, top, region[:, 1] / res, region[:, 0] / res)
    return separable_resize_chips(grays[..., None], frame_idx, mats, res, res)


def _resample_super(supers: torch.Tensor, frac_h: torch.Tensor,
                    frac_w: torch.Tensor, out_res: int) -> torch.Tensor:
    """Centred sub-patches cut from super-patches.

    supers [N, SUP, SUP, 1]; frac_h/frac_w [N, S] — per-(slot, sample)
    fraction of the super-patch the sub-patch covers → [N, S, out, out].
    """
    N, SUP = supers.shape[0], supers.shape[1]
    S = frac_h.shape[1]
    side_y = frac_h * SUP
    side_x = frac_w * SUP
    off_y = (SUP - side_y) / 2.0
    off_x = (SUP - side_x) / 2.0
    mats = _region_matrices(off_x, off_y, side_x / out_res,
                            side_y / out_res).reshape(N * S, 2, 3)
    idx = torch.arange(N, device=supers.device).repeat_interleave(S)
    out = separable_resize_chips(supers, idx, mats, out_res, out_res)
    return out[..., 0].reshape(N, S, out_res, out_res)


def _scale_fft_from_samples(samples: torch.Tensor) -> torch.Tensor:
    """[N, SCALE_N, F, F] scale samples → feature FFTs [N, DF, Sr].

    Per-sample standardization, hann window across the scale axis, rfft
    along scales per feature dimension (Danelljan's 1-D scale filter)."""
    N = samples.shape[0]
    feats = samples.reshape(N, SCALE_N, _SCALE_DF)
    feats = feats - feats.mean(dim=-1, keepdim=True)
    feats = feats / (torch.sqrt((feats ** 2).mean(dim=-1, keepdim=True))
                     + 1e-5)
    feats = feats * _tables(samples.device).scale_hann[None, :, None]
    return torch.fft.rfft(feats.transpose(1, 2), dim=-1)    # [N, DF, Sr]


def _scale_feature_ffts(grays: torch.Tensor, frame_idx: torch.Tensor,
                        pos: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """Scale-sample feature FFTs: [N, DF, Sr] complex.

    Sample s covers ``size × SCALE_STEP**(s - S//2)`` centred at ``pos``,
    resized to SCALE_FEAT².  Extraction is hierarchical: one super-patch
    per slot covering the largest sample is pulled from the frame, and the
    SCALE_N samples are resampled from it.  (Used on the init paths;
    ``_step_core`` shares one ``_STEP_SUPER`` patch between the scale
    measure and both filter updates.)
    """
    N = pos.shape[0]
    factors = _tables(grays.device).factors
    supers = _super_patch(grays, frame_idx, pos, _SPAN * size, _SCALE_SUPER)
    frac = (factors / _SPAN)[None, :].repeat(N, 1)          # [N, S]
    samples = _resample_super(supers, frac, frac, SCALE_FEAT)
    return _scale_fft_from_samples(samples)


def _scale_filter_init(grays, frame_idx, pos, size):
    """(num complex [N, DF, Sr], den [N, Sr]) for fresh scale filters."""
    F = _scale_feature_ffts(grays, frame_idx, pos, size)
    Gs = _tables(grays.device).Gs
    num = Gs[None, None, :] * torch.conj(F)
    den = torch.sum((F * torch.conj(F)).real, dim=1)
    return num, den


def _extract_patches(grays: torch.Tensor, frame_idx: torch.Tensor,
                     pos: torch.Tensor, size: torch.Tensor,
                     rel_scales: torch.Tensor) -> torch.Tensor:
    """Batched patch sampling: [N slots] × [S scales] → [N, S, P, P].

    Patch (n, s) covers ``PATCH_SCALE × size[n] × rel_scales[s]`` centred
    at ``pos[n]`` in frame ``frame_idx[n]`` of ``grays``.  No patch size
    cap: any face size samples exactly.
    """
    N = pos.shape[0]
    S = rel_scales.shape[0]
    region = (PATCH_SCALE * size[:, None, :]
              * rel_scales[None, :, None])              # [N, S, 2] (h, w)
    top = pos[:, None, 0] - region[..., 0] / 2.0
    left = pos[:, None, 1] - region[..., 1] / 2.0
    matrices = _region_matrices(left, top, region[..., 1] / P,
                                region[..., 0] / P).reshape(N * S, 2, 3)
    idx = frame_idx.repeat_interleave(S)
    out = separable_resize_chips(grays[..., None], idx, matrices, P, P)
    return out[..., 0].reshape(N, S, P, P)


def _features(patch: torch.Tensor, hann: torch.Tensor) -> torch.Tensor:
    """MOSSE preprocessing: log, standardize, cosine window.

    Works on any [..., P, P] batch (statistics per patch).
    """
    f = torch.log1p(patch)
    f = f - f.mean(dim=(-2, -1), keepdim=True)
    f = f / (torch.sqrt((f ** 2).mean(dim=(-2, -1), keepdim=True)) + 1e-5)
    return f * hann


def _slot_ffts(grays: torch.Tensor, frame_idx: torch.Tensor,
               pos: torch.Tensor, size: torch.Tensor,
               hann: torch.Tensor) -> torch.Tensor:
    """rfft2 of the scale-1 feature patch for every slot: [N, P, Pr]."""
    patches = _extract_patches(grays, frame_idx, pos, size,
                               _tables(grays.device).one)[:, 0]
    return torch.fft.rfft2(_features(patches, hann))


def _filter_init_from_boxes(grays: torch.Tensor, frame_idx: torch.Tensor,
                            boxes: torch.Tensor):
    """MOSSE filter initialisation for a batch of boxes.

    ``frame_idx`` [M] names each box's frame in ``grays``.  Returns (pos
    [M, 2], size [M, 2], num complex [M, P, Pr], den [M, P, Pr], s_num,
    s_den) — shared by ``start_tracks`` (scatter into chosen slots) and
    ``restart_slots`` (full-width select) so the init math cannot diverge.
    """
    c = _tables(grays.device)
    pos = torch.stack(
        [(boxes[:, 1] + boxes[:, 3]) / 2.0, (boxes[:, 0] + boxes[:, 2]) / 2.0],
        dim=1)
    size = torch.stack(
        [boxes[:, 3] - boxes[:, 1], boxes[:, 2] - boxes[:, 0]], dim=1)
    size = size.clamp_min(4.0)

    F = _slot_ffts(grays, frame_idx, pos, size, c.hann)
    num = c.G[None] * torch.conj(F)
    den = (F * torch.conj(F)).real
    s_num, s_den = _scale_filter_init(grays, frame_idx, pos, size)
    return pos, size, num, den, s_num, s_den


def start_tracks(state: TrackState, gray: torch.Tensor, boxes: torch.Tensor,
                 slots: torch.Tensor, mask: torch.Tensor) -> TrackState:
    """Initialise trackers in the given slots from detection boxes.

    gray [H, W] float32; boxes [M, 4] (left, top, right, bottom);
    slots [M] integer target slot per box; mask [M] bool (padding rows off).
    """
    grays = gray[None]
    zero_idx = torch.zeros((boxes.shape[0],), dtype=torch.long,
                           device=gray.device)
    pos, size, num, den, s_num, s_den = _filter_init_from_boxes(
        grays, zero_idx, boxes)
    safe = torch.where(mask, slots.to(torch.long), torch.zeros_like(zero_idx))

    def scatter(field, updates):
        # rows with ``mask`` false write slot 0 back with its own value
        m = mask.reshape((-1,) + (1,) * (updates.ndim - 1))
        upd = torch.where(m, updates.to(field.dtype), field[safe])
        return field.index_put((safe,), upd)

    return TrackState(
        pos=scatter(state.pos, pos),
        size=scatter(state.size, size),
        num_re=scatter(state.num_re, num.real),
        num_im=scatter(state.num_im, num.imag),
        den=scatter(state.den, den),
        s_num_re=scatter(state.s_num_re, s_num.real),
        s_num_im=scatter(state.s_num_im, s_num.imag),
        s_den=scatter(state.s_den, s_den),
        alive=scatter(state.alive, mask),
    )


def restart_slots(state: TrackState, grays: torch.Tensor,
                  frame_idx: torch.Tensor, boxes: torch.Tensor,
                  mask: torch.Tensor) -> TrackState:
    """Re-initialise EVERY masked slot from its box — select, not scatter.

    frame_idx [N] the frame each slot restarts from; boxes [N, 4] (one per
    slot), mask [N] bool.  Masked-off rows leave their slots bit-identical.
    """
    pos, size, num, den, s_num, s_den = _filter_init_from_boxes(
        grays, frame_idx, boxes)

    m1 = mask[:, None]
    m3 = mask[:, None, None]
    return TrackState(
        pos=torch.where(m1, pos, state.pos),
        size=torch.where(m1, size, state.size),
        num_re=torch.where(m3, num.real, state.num_re),
        num_im=torch.where(m3, num.imag, state.num_im),
        den=torch.where(m3, den, state.den),
        s_num_re=torch.where(m3, s_num.real, state.s_num_re),
        s_num_im=torch.where(m3, s_num.imag, state.s_num_im),
        s_den=torch.where(m1, s_den, state.s_den),
        alive=state.alive | mask,
    )


def _psr(resp: torch.Tensor, idx: torch.Tensor):
    """Peak-to-sidelobe ratio and peak bin (py, px) of each [P, P] response."""
    N = resp.shape[0]
    flat = resp.reshape(N, P * P)
    flat_idx = flat.argmax(dim=1)            # first maximum, as jnp.argmax
    py = flat_idx // P
    px = flat_idx % P
    peak = flat.gather(1, flat_idx[:, None])[:, 0]
    ay = (idx[None, :] - py[:, None]).abs()
    ax = (idx[None, :] - px[:, None]).abs()
    dy = torch.minimum(ay, P - ay)
    dx = torch.minimum(ax, P - ax)
    side = ((dy[:, :, None] > PSR_WINDOW)
            | (dx[:, None, :] > PSR_WINDOW)).to(resp.dtype)   # [N, P, P]
    n_side = side.sum(dim=(1, 2)).clamp_min(1.0)
    mu = (resp * side).sum(dim=(1, 2)) / n_side
    var = (((resp - mu[:, None, None]) ** 2) * side).sum(dim=(1, 2)) / n_side
    return (peak - mu) / torch.sqrt(var + 1e-8), py, px


def _step_core(state: TrackState, grays: torch.Tensor,
               slot_frame: torch.Tensor, min_confidence):
    """Advance ALL slots one frame (batched dlib ``update``).

    ``slot_frame[n]`` names the frame of ``grays`` slot n tracks in.
    Returns (new_state, boxes [N, 4], confidences [N]).  Slots whose PSR
    drops below ``min_confidence`` are marked dead; dead slots freeze.
    """
    c = _tables(grays.device)

    # --- translation: single-scale response -------------------------------
    patches = _extract_patches(grays, slot_frame, state.pos, state.size,
                               c.one)[:, 0]
    Fz = torch.fft.rfft2(_features(patches, c.hann))        # [N, P, Pr]
    num = torch.complex(state.num_re, state.num_im)
    resp = torch.fft.irfft2(Fz * num / (state.den + LAMBDA), s=(P, P))
    psr, py, px = _psr(resp, c.idx)

    dy_pix = torch.where(py <= P // 2, py, py - P).to(torch.float32)
    dx_pix = torch.where(px <= P // 2, px, px - P).to(torch.float32)
    region = PATCH_SCALE * state.size
    new_pos = state.pos + torch.stack(
        [dy_pix * region[:, 0] / P, dx_pix * region[:, 1] / P], dim=1)

    # --- one shared super-patch at the new position -----------------------
    # The scale-measure stack, the translation-filter update patch and the
    # scale-filter update all sample the same neighbourhood of new_pos; one
    # frame-resolution access covers the union (PATCH_SCALE·span·size
    # bounds 2×new_size and span×{size, new_size}) and the consumers
    # resample from it.
    sup_region = (PATCH_SCALE * _SPAN) * state.size         # [N, 2]
    supers = _super_patch(grays, slot_frame, new_pos, sup_region, _STEP_SUPER)

    # --- scale: 1-D correlation over SCALE_N samples at the new position --
    frac_s = (c.factors[None, :, None] * state.size[:, None, :]
              / sup_region[:, None, :])                     # [N, S, 2]
    Fs = _scale_fft_from_samples(
        _resample_super(supers, frac_s[..., 0], frac_s[..., 1], SCALE_FEAT))
    s_num = torch.complex(state.s_num_re, state.s_num_im)
    s_resp = torch.fft.irfft(
        torch.sum(s_num * Fs, dim=1) / (state.s_den + LAMBDA), n=SCALE_N,
        dim=-1)                                             # [N, SCALE_N]
    # integer-bin argmax, like dlib's DSST: the quantisation is the
    # deadzone that keeps static targets from random-walking in size
    peak = s_resp.argmax(dim=1)                             # [N]
    kbin = peak.to(torch.float32) - SCALE_N // 2
    rel = torch.pow(c.scale_step, kbin)                     # float32 power
    new_size = (state.size * rel[:, None]).clamp_min(4.0)

    # --- update both filters at the new position --------------------------
    frac_u = PATCH_SCALE * new_size / sup_region            # [N, 2]
    upd_patch = _resample_super(supers, frac_u[:, None, 0],
                                frac_u[:, None, 1], P)[:, 0]
    Fn = torch.fft.rfft2(_features(upd_patch, c.hann))
    upd = c.G[None] * torch.conj(Fn)
    new_num_re = (1.0 - ETA) * state.num_re + ETA * upd.real
    new_num_im = (1.0 - ETA) * state.num_im + ETA * upd.imag
    new_den = (1.0 - ETA) * state.den + ETA * (Fn * torch.conj(Fn)).real

    # the scale filter trains on the measurement stack Fs (sampled around
    # the previous size); to train consistently, the Gaussian target is
    # circularly shifted to the measured scale ``kbin`` (a phase ramp on
    # its rfft)
    ang = (-2.0 * torch.pi / SCALE_N) * kbin[:, None] * c.freqs[None, :]
    shift = torch.complex(torch.cos(ang), torch.sin(ang))   # [N, Sr]
    s_upd = (c.Gs[None, None, :] * shift[:, None, :]) * torch.conj(Fs)
    new_s_num_re = (1.0 - SCALE_ETA) * state.s_num_re + SCALE_ETA * s_upd.real
    new_s_num_im = (1.0 - SCALE_ETA) * state.s_num_im + SCALE_ETA * s_upd.imag
    new_s_den = ((1.0 - SCALE_ETA) * state.s_den
                 + SCALE_ETA * torch.sum((Fs * torch.conj(Fs)).real, dim=1))

    a1 = state.alive[:, None]
    a3 = state.alive[:, None, None]
    pos = torch.where(a1, new_pos, state.pos)
    size = torch.where(a1, new_size, state.size)
    num_re = torch.where(a3, new_num_re, state.num_re)
    num_im = torch.where(a3, new_num_im, state.num_im)
    den = torch.where(a3, new_den, state.den)
    s_num_re = torch.where(a3, new_s_num_re, state.s_num_re)
    s_num_im = torch.where(a3, new_s_num_im, state.s_num_im)
    s_den = torch.where(a1, new_s_den, state.s_den)
    conf = torch.where(state.alive, psr, torch.full_like(psr, -torch.inf))
    alive = state.alive & (conf >= min_confidence)
    boxes = torch.stack(
        [pos[:, 1] - size[:, 1] / 2, pos[:, 0] - size[:, 0] / 2,
         pos[:, 1] + size[:, 1] / 2, pos[:, 0] + size[:, 0] / 2],
        dim=1)
    return (TrackState(pos, size, num_re, num_im, den,
                       s_num_re, s_num_im, s_den, alive), boxes, conf)


def step(state: TrackState, gray: torch.Tensor,
         min_confidence: float = 10.0):
    """Single-frame convenience wrapper over ``_step_core``."""
    slot_frame = torch.zeros((state.alive.shape[0],), dtype=torch.long,
                             device=gray.device)
    return _step_core(state, gray[None], slot_frame, min_confidence)


# ---------------------------------------------------------------------------
# Whole-shot scan: DSST + association + track bookkeeping, no host sync
# ---------------------------------------------------------------------------
# Packed per-slot emission layout (host reads one array per pass):
PACK_BOX = slice(0, 4)   # l, t, r, b (pixel coords)
PACK_CONF = 4            # PSR confidence
PACK_STATUS = 5          # 0 dead / 1 tracked / 2 detection point
PACK_UID = 6             # track uid (int, stored as float)
PACK_DET = 7             # detection index at this frame (-1 if none)
PACK_WIDTH = 8

_NEG = -1e30


def _optimal_match(overlap: torch.Tensor) -> torch.Tensor:
    """Exact maximum-total-overlap one-to-one matching on device.

    overlap [N, D] (zeros = gated out / invalid) → match_slot [D] int64
    (slot per detection, -1 unmatched).  Same objective as the reference's
    Hungarian over the gated overlap matrix: maximise the summed overlap of
    the chosen pairs, zero-overlap pairs never matched.

    A bitmask DP over detection subsets: dp[mask] = best total overlap with
    used-detection set ``mask`` after a prefix of trackers, advanced one
    tracker per step over a [2^D, D] table, then backtracked.  Ties break
    as in the JAX package (skip beats a tied match, the lowest detection
    index wins, the lowest end mask wins).  N forward and N backward steps
    of a few small launches each, none of which waits for the device.
    """
    N, D = overlap.shape
    if D > 12:  # 2^D DP table; crowd shots bucket detections past 12
        return _jv_match(overlap)
    dev = overlap.device
    t = _match_tables(D, dev)
    neg = torch.full((), _NEG, dtype=torch.float32, device=dev)
    # zero-gated pairs must never be chosen
    ov = torch.where(overlap > 0.0, overlap.to(torch.float32), neg)

    dp = torch.full((1 << D,), _NEG, dtype=torch.float32, device=dev)
    dp[0] = 0.0
    choices = []
    for n in range(N):
        # candidate: tracker n takes detection d, completing ``mask``
        cand = torch.where(t.has_d, dp[t.prev_mask] + ov[n][None, :], neg)
        best = cand.amax(dim=1)
        best_d = cand.argmax(dim=1)          # lowest detection on ties
        take = best > dp                     # strict: ties skip
        dp = torch.where(take, best, dp)
        choices.append(torch.where(take, best_d, torch.full_like(best_d, -1)))

    mask = dp.argmax().reshape(1)            # lowest mask on ties
    match_slot = torch.full((D,), -1, dtype=torch.long, device=dev)
    for n in range(N - 1, -1, -1):
        d = choices[n].gather(0, mask)       # [1]
        assigned = d >= 0
        safe = d.clamp_min(0)                # d = -1 must not index the end
        match_slot = torch.where(assigned, match_slot.scatter(0, safe, n),
                                 match_slot)
        mask = torch.where(assigned, mask ^ t.bit.gather(0, safe), mask)
    return match_slot


def _jv_match(overlap: torch.Tensor) -> torch.Tensor:
    """Exact assignment for wide matrices: Jonker–Volgenant on device.

    Same contract/objective as ``_optimal_match``, used when D > 12 makes
    the bitmask DP table too big (crowd shots).  Shortest augmenting paths
    over the zero-padded square cost matrix ``-overlap``.  The JAX
    package's data-dependent ``while_loop``s run here with fixed trip
    counts and masks: a path search marks one more column used per
    iteration, so it ends within n + 1 iterations, and an augmentation
    walks back over at most n + 1 columns; once a search or a walk is
    done, the remaining iterations change nothing.
    """
    N, D = overlap.shape
    n = max(N, D)
    dev = overlap.device
    INF = 3.4e38
    # rows/cols are 1-indexed (index 0 is the JV virtual source); index
    # n+1 is a parking slot for masked scatter writes
    cost = torch.zeros((n + 2, n + 2), dtype=torch.float32, device=dev)
    cost[1:N + 1, 1:D + 1] = -overlap.to(torch.float32)
    inf = torch.full((n + 2,), INF, dtype=torch.float32, device=dev)
    park = torch.full((n + 2,), n + 1, dtype=torch.long, device=dev)
    zero = torch.zeros((1,), dtype=torch.float32, device=dev)

    u = torch.zeros((n + 2,), dtype=torch.float32, device=dev)
    v = torch.zeros((n + 2,), dtype=torch.float32, device=dev)
    p = torch.zeros((n + 2,), dtype=torch.long, device=dev)
    way = torch.zeros((n + 2,), dtype=torch.long, device=dev)
    for i in range(1, n + 1):
        p = p.clone()
        p[0] = i
        minv = inf.clone()
        minv[0] = -INF
        used = torch.zeros((n + 2,), dtype=torch.bool, device=dev)
        used[n + 1] = True
        j0 = torch.zeros((1,), dtype=torch.long, device=dev)
        done = torch.zeros((1,), dtype=torch.bool, device=dev)
        for _ in range(n + 1):                      # path search
            used2 = used.scatter(0, j0, True)
            i0 = p.gather(0, j0)
            cur = cost.index_select(0, i0)[0] - u.gather(0, i0) - v
            upd = ~used2 & (cur < minv)
            minv2 = torch.where(upd, cur, minv)
            way2 = torch.where(upd, j0, way)
            cand = torch.where(used2, inf, minv2)
            j1 = cand[:n + 1].argmin().reshape(1)
            delta = cand.gather(0, j1)
            # u[p[j]] += delta for used j; the parking slot absorbs the rest
            u2 = u.index_add(0, torch.where(used2, p, park),
                             torch.where(used2, delta, zero))
            v2 = torch.where(used2, v - delta, v)
            minv3 = torch.where(used2, minv2, minv2 - delta)
            u = torch.where(done, u, u2)
            v = torch.where(done, v, v2)
            minv = torch.where(done, minv, minv3)
            used = torch.where(done, used, used2)
            way = torch.where(done, way, way2)
            j0 = torch.where(done, j0, j1)
            done = done | (p.gather(0, j0) == 0)
        for _ in range(n + 1):                      # augmentation
            walking = j0 != 0
            j1 = way.gather(0, j0)
            p = torch.where(walking, p.scatter(0, j0, p.gather(0, j1)), p)
            j0 = torch.where(walking, j1, j0)

    # p[j] = row assigned to column j (1-indexed); keep real positive pairs
    cols = torch.arange(D, device=dev)
    rows = p[1:D + 1] - 1
    ok = ((rows >= 0) & (rows < N)
          & (overlap[rows.clamp(0, N - 1), cols] > 0.0))
    return torch.where(ok, rows, torch.full_like(rows, -1))


def _det_branch(st: TrackState, uid, next_uid, grays, slot_frame, dboxes,
                dvalid, tboxes, min_overlap_ratio, dup_containment):
    """A detection frame's association: match, suppress duplicates, restart
    matched slots from their detections, spawn tracks in free slots."""
    N = st.alive.shape[0]
    dev = grays.device
    slots = torch.arange(N, device=dev)
    alive = st.alive
    ov = gated_overlap_t(tboxes, dboxes, min_overlap_ratio)
    ov = torch.where(alive[:, None] & dvalid[None, :], ov,
                     torch.zeros_like(ov))
    match_slot = _optimal_match(ov)               # [D] slot or -1
    matched = match_slot >= 0

    # duplicate suppression: unmatched detection mostly contained in /
    # containing a surviving (unmatched) tracker → no new track
    slot_matched = torch.zeros((N,), dtype=torch.long, device=dev).index_add_(
        0, match_slot.clamp_min(0), matched.to(torch.long)) > 0
    cont = overlap_min_ratio_t(tboxes, dboxes)    # [N, D]
    live_unmatched = alive & ~slot_matched
    cont_live = torch.where(live_unmatched[:, None], cont,
                            torch.zeros_like(cont))
    dup = (cont_live.amax(dim=0) > dup_containment) & dvalid
    # the suppressing slot ABSORBS the duplicate's detection node (the host
    # links fwd/bwd tracks through it), otherwise the opposite pass — which
    # meets the duplicate first — still spawns a twin
    dup_slot = cont_live.argmax(dim=0)            # first maximum
    spawn = dvalid & ~matched & ~dup

    # free-slot assignment for spawns (stable: lowest slots first)
    slot_order = torch.argsort(alive.to(torch.int32), stable=True)
    n_free = (~alive).sum()
    rank = torch.cumsum(spawn.to(torch.long), dim=0) - 1
    has_slot = spawn & (rank < n_free)
    new_slot = slot_order[rank.clamp(0, N - 1)]
    dropped = (spawn & ~has_slot).sum()
    target = torch.where(matched, match_slot,
                         torch.where(has_slot, new_slot,
                                     torch.full_like(new_slot, -1)))
    restart = target >= 0

    # per-slot view of the (injective) detection → slot map
    onehot = (target[None, :] == slots[:, None]) & restart[None, :]
    slot_has_det = onehot.any(dim=1)
    det_for_slot = onehot.to(torch.int32).argmax(dim=1)

    # fresh uids for spawned tracks; matched restarts keep their uid
    fresh = restart & ~matched
    fresh_rank = torch.cumsum(fresh.to(torch.long), dim=0) - 1
    slot_is_fresh = slot_has_det & fresh[det_for_slot]
    uid = torch.where(slot_is_fresh, next_uid + fresh_rank[det_for_slot], uid)
    next_uid = next_uid + fresh.sum()

    # restart trackers from their detection boxes: fresh filter state; a
    # matched slot's old filter dies and its detection re-seeds the same
    # slot, continuing the track uid
    slot_boxes = dboxes[det_for_slot]
    st = restart_slots(st, grays, slot_frame, slot_boxes, slot_has_det)

    # absorbed-duplicate links (disjoint from restarted slots: the
    # suppressor is live and unmatched, restarts hit matched/free slots)
    onehot_abs = (dup_slot[None, :] == slots[:, None]) & dup[None, :]
    slot_abs = onehot_abs.any(dim=1) & live_unmatched
    abs_det = onehot_abs.to(torch.int32).argmax(dim=1)

    return (st, uid, next_uid, slot_has_det, det_for_slot, slot_boxes,
            slot_abs, abs_det, dropped)


def shot_scan(state: TrackState, uid: torch.Tensor, next_uid,
              grays: torch.Tensor, frame_valid: np.ndarray,
              det_boxes, det_valid: np.ndarray,
              min_confidence, min_overlap_ratio, dup_containment,
              frame_index: Optional[np.ndarray] = None):
    """Tracking over a whole shot without one wait for the device.

    Every step advances all tracker slots (batched DSST); detection steps
    run exact optimal association on device (``_optimal_match``), restart
    matched trackers from their detections (continuing the track uid) and
    spawn new tracks for unmatched detections.  The host reads back one
    packed array per pass and only rebuilds track lists.

    Parameters
    ----------
    state, uid, next_uid : N tracker slots ([N] integer uids) and the
        fresh-uid counter (an int or a 0-dim integer tensor).
    grays : [F, H, W] float32 on the scan's device.
    frame_valid : [T] bool numpy — steps marked False are skipped.
    det_boxes : [T, D, 4] float32 (numpy or tensor), det_valid : [T, D]
        bool numpy, both in step order.  Which steps run association is
        decided on the host from ``frame_valid`` and ``det_valid``.
    min_overlap_ratio : the association gate.
    dup_containment : suppress spawning a new track for an unmatched
        detection whose containment overlap (intersection / min area) with
        a surviving tracker exceeds this.
    frame_index : [T] integer numpy — the frame of ``grays`` each step
        reads; default ``arange(T)``.  The backward pass gives the reversed
        order instead of a flipped copy of the stack.

    Returns
    -------
    (state, uid, next_uid), packed [T, N, PACK_WIDTH], dropped [T]
        ``dropped[t]`` counts detections that found no free slot (the
        caller retries the shot with a bigger slot bucket).
    """
    dev = grays.device
    N = state.alive.shape[0]
    frame_valid = np.asarray(frame_valid, dtype=bool)
    det_valid = np.asarray(det_valid, dtype=bool) & frame_valid[:, None]
    T = frame_valid.shape[0]
    if frame_index is None:
        frame_index = np.arange(T)
    has_dets = det_valid.any(axis=1)                       # host decision
    det_boxes_d = torch.as_tensor(det_boxes, dtype=torch.float32).to(dev)
    det_valid_d = torch.from_numpy(det_valid).to(dev)
    uid = uid.to(torch.long)
    next_uid = torch.as_tensor(next_uid, dtype=torch.long).to(dev)

    packed = torch.zeros((T, N, PACK_WIDTH), dtype=torch.float32, device=dev)
    dropped = torch.zeros((T,), dtype=torch.long, device=dev)
    minus_one = torch.full((N,), -1.0, dtype=torch.float32, device=dev)
    st = state
    for t in range(T):
        if not frame_valid[t]:
            continue
        slot_frame = torch.full((N,), int(frame_index[t]), dtype=torch.long,
                                device=dev)
        alive_before = st.alive
        st, tboxes, conf = _step_core(st, grays, slot_frame, min_confidence)
        status = (alive_before & (conf >= min_confidence)).to(torch.float32)
        out_box, out_det = tboxes, minus_one
        if has_dets[t]:
            (st, uid, next_uid, slot_has_det, det_for_slot, slot_boxes,
             slot_abs, abs_det, dropped_t) = _det_branch(
                st, uid, next_uid, grays, slot_frame, det_boxes_d[t],
                det_valid_d[t], tboxes, min_overlap_ratio, dup_containment)
            dropped[t] = dropped_t
            out_box = torch.where(slot_has_det[:, None], slot_boxes, tboxes)
            status = torch.where(slot_has_det, torch.full_like(status, 2.0),
                                 status)
            out_det = torch.where(
                slot_has_det, det_for_slot.to(torch.float32),
                torch.where(slot_abs, abs_det.to(torch.float32), minus_one))
        packed[t] = torch.cat(
            [out_box, conf[:, None], status[:, None],
             uid.to(torch.float32)[:, None], out_det[:, None]], dim=1)
    return (st, uid, next_uid), packed, dropped


def track_scan(state: TrackState, grays: torch.Tensor,
               min_confidence: float = 10.0):
    """Track through a frame block.

    grays [T, H, W] float32 → (final_state, boxes [T, N, 4], confs [T, N],
    alive_before [T, N]).  ``alive_before[t]`` tells which slots were live
    when frame t was processed.
    """
    T = grays.shape[0]
    N = state.alive.shape[0]
    boxes, confs, alive = [], [], []
    for t in range(T):
        alive.append(state.alive)
        slot_frame = torch.full((N,), t, dtype=torch.long, device=grays.device)
        state, b, c = _step_core(state, grays, slot_frame, min_confidence)
        boxes.append(b)
        confs.append(c)
    return state, torch.stack(boxes), torch.stack(confs), torch.stack(alive)
