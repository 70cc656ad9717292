"""The port's dlib ``.dat`` converters, on the CPU.

``models/dlib_convert.py`` is a host copy of the JAX package's module.  The
packaged cascade, embedder and detector are written with the port's
writers (byte-equal to the JAX writers' files), converted back and loaded
into the port, whose forward on them equals its forward on the packaged
weights.  The writers and the reader walk every value in Python, so the
cascade is cut to its first 2 stages of 32 trees and the embedder to an
eighth of its width (the whole of both takes minutes).  The cascade
agrees within 5e-3 px, the landmark tolerance of
``tests/test_torch_extract.py`` (its mean shape goes through dlib's [0, 1]
frame and back, a float32 rounding), the embedder within 1e-5
(dlib's affine layers fold batch norm; converted nets emit unnormalised
embeddings, so they are compared after L2 normalisation), the detector's
score map within 1e-4 (the MMOD format carries one output channel).
"""

import numpy as np
import pytest
import torch

from pyannote_video_tpu.models import dlib_convert as jdlib
from pyannote_video_tpu.models.weights import DETECTOR_FILE as J_DETECTOR_FILE

from pyannote_video_tpu_torch.models import dlib_convert, embedder, landmarks, nn
from pyannote_video_tpu_torch.models.detector import forward_maps
from pyannote_video_tpu_torch.models.weights import (DETECTOR_FILE,
                                                     EMBEDDER_FILE,
                                                     LANDMARKS_FILE)
from pyannote_video_tpu_torch.ops.color import to_gray
from pyannote_video_tpu_torch.utils.synthetic import synthetic_episode

pytestmark = pytest.mark.skipif(
    not J_DETECTOR_FILE.exists(), reason="no trained weights")


def _flat(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _nested(flat):
    """A flat ``.npz`` as the JAX package's nested parameter set."""
    out = {}
    for key, value in flat.items():
        *parents, name = key.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = value
    return out


def _write_both(tmp_path, writer, params, **kw):
    ours, ref = tmp_path / "ours.dat", tmp_path / "ref.dat"
    getattr(dlib_convert, writer)(str(ours), params, **kw)
    getattr(jdlib, writer)(str(ref), params, **kw)
    assert ours.read_bytes() == ref.read_bytes()
    return str(ours)


def _cut_cascade(flat, n_stages=2, n_trees=32):
    """The packaged cascade's first stages and trees: the writers and the
    reader walk every value in Python (~80 s for all 15 × 224 trees)."""
    cut = {"mean_shape": flat["mean_shape"], "depth": flat["depth"],
           "n_stages": np.asarray(n_stages), "bilinear_tail": np.asarray(n_stages)}
    for k in range(n_stages):
        for name in ("anchor", "offset"):
            cut[f"s{k}/{name}"] = flat[f"s{k}/{name}"]
        for name in ("i1", "i2", "thresh", "leaves"):
            cut[f"s{k}/{name}"] = flat[f"s{k}/{name}"][:n_trees]
    return cut


def test_shape_predictor_round_trip(tmp_path):
    packaged = _cut_cascade(_flat(LANDMARKS_FILE))
    path = _write_both(tmp_path, "write_shape_predictor", packaged)
    conv = dlib_convert.convert_shape_predictor(path)
    ref = jdlib.convert_shape_predictor(path)
    assert conv.keys() == ref.keys()
    for k in conv:
        np.testing.assert_array_equal(np.asarray(conv[k]), np.asarray(ref[k]))
    # dlib samples at the nearest pixel; the packaged cascade's sampling mode
    # is not in the wire format, so it is pinned back for the comparison
    conv["bilinear_tail"] = int(packaged["bilinear_tail"])
    ours = landmarks.cascade_from_jax(conv)
    base = landmarks.cascade_from_jax(packaged)

    ep = synthetic_episode(n_shots=1, shot_frames=4, width=160, height=120, seed=3)
    grays = to_gray(torch.from_numpy(ep.frames))
    boxes = torch.tensor([list(f.box) for f in ep.faces], dtype=torch.float32)
    fidx = torch.tensor([f.frame for f in ep.faces])
    lm = landmarks.predict_crops(ours, grays, fidx, boxes)
    lm_base = landmarks.predict_crops(base, grays, fidx, boxes)
    assert float((lm - lm_base).abs().max()) <= 5e-3


def _cut_embedder(flat, div=8):
    """The packaged ResNet-29 at 1/``div`` of its width: the first channels
    of every layer (every channel count but the 3 input channels is
    divided alike, so each layer still reads the channels its input layer
    keeps; the 128 embedding outputs stay); the full net takes minutes
    through the writers."""
    def keep(n):
        return n if n == 3 else n // div

    cut = {}
    for key, value in flat.items():
        if key == "fc":
            cut[key] = value[:keep(value.shape[0])]
        elif value.ndim == 4:
            cut[key] = value[:, :, :keep(value.shape[2]), :keep(value.shape[3])]
        elif value.ndim == 1:
            cut[key] = value[:keep(value.shape[0])]
        else:
            cut[key] = value
    return cut


def test_face_recognition_round_trip(tmp_path):
    cut = _cut_embedder(_flat(EMBEDDER_FILE))
    path = _write_both(tmp_path, "write_face_recognition", _nested(cut))
    conv = dlib_convert.convert_face_recognition(path)
    ours = nn.params_from_jax(conv)
    assert ours["normalized_head"] is False
    base = nn.params_from_jax(cut)
    assert base["stem"]["w"].shape == (4, 3, 7, 7)

    chips = torch.from_numpy(np.random.default_rng(1).integers(
        0, 255, (3, 150, 150, 3)).astype(np.float32))
    with torch.no_grad():
        out = embedder.forward(ours, chips, compute_dtype=torch.float32)
        ref = embedder.forward(base, chips, compute_dtype=torch.float32)
    out = out / out.norm(dim=1, keepdim=True)
    assert float((out - ref).abs().max()) <= 1e-5


def test_mmod_detector_round_trip(tmp_path):
    packaged = _nested(_flat(DETECTOR_FILE))
    meta = {"windows": [(40, 40, "face")], "overlaps_nms": (0.4, 1.0)}
    path = _write_both(tmp_path, "write_mmod_detector", packaged, meta=meta)
    conv = dlib_convert.convert_mmod_detector(path)
    assert conv["mmod_meta"]["windows"] == [(40, 40, "face")]
    ours = nn.params_from_jax({k: v for k, v in conv.items() if k != "mmod_meta"})
    base = nn.load_params(DETECTOR_FILE)

    img = torch.from_numpy(np.random.default_rng(2).integers(
        0, 255, (1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        maps = forward_maps(ours, img, compute_dtype=torch.float32)
        ref = forward_maps(base, img, compute_dtype=torch.float32)
    assert float((maps[..., 0] - ref[..., 0]).abs().max()) <= 1e-4
    assert float(maps[..., 1:].abs().max()) == 0.0
