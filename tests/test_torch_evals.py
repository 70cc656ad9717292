"""The port's quality harnesses against the JAX package's, on the CPU.

``evaluate`` on a small episode (4 shots × 10 frames @ 320×240, seed 101)
in domains A and BC: every F1, precision, recall, purity, ``n_tracks`` and
``n_clusters`` equal to the JAX harness's, the landmark error within 1e-3.
``probe`` (through ``main``) on domain A, seed 101: ``gt``,
``missed_at_0.5`` and ``fp_n`` equal; the score statistics within
``SCORE_TOL`` logits.  The detector serves in bfloat16: a JAX bf16
convolution returns float32, the port's rounds its output to bf16 (8
significant bits), so at the logits of real faces (8–16, where a bf16 ulp
is 0.0625) the two differ by a few ulps, and a percentile can fall on
another face; 0.25 is four such ulps (0.12 seen).

Domain C's motion blur is the port's own (``box_blur_rows``), bit for bit
OpenCV's: the shifted episodes' frames are byte-equal to the JAX ones.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from pyannote_video_tpu_torch.evals import eval_synthetic, probe_detector

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(n_shots=4, shot_frames=10, width=320, height=240)
EQUAL_KEYS = ("boundary_f1", "thread_f1", "scene_f1", "track_f1",
              "track_precision", "track_recall", "cluster_purity",
              "cluster_recall", "cluster_precision", "n_tracks", "n_clusters")
LANDMARK_TOL = 1e-3
SCORE_TOL = 0.25

# whole episodes run on the CPU here: six test workers at full torch width
# thrash
torch.set_num_threads(1)


def _jax_module(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "evals" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("k", [5, 7, 9])
def test_box_blur_rows_is_cv2_blur(k):
    import cv2

    rng = np.random.default_rng(k)
    image = rng.uniform(0, 300, (40, 64, 3)).astype(np.float32)
    image[:, :6] *= np.float32(1e-3)
    assert np.array_equal(eval_synthetic.box_blur_rows(image, k),
                          cv2.blur(image, (k, 1)))


@pytest.mark.parametrize("domain", ["C", "BC"])
def test_shifted_episode_frames_equal_jax(domain):
    from pyannote_video_tpu.utils.synthetic import synthetic_episode as jepisode
    from pyannote_video_tpu.utils.synthetic_shift import domain_hooks
    from pyannote_video_tpu_torch.utils.synthetic import synthetic_episode

    kwargs = dict(n_shots=3, shot_frames=4, width=160, height=120, seed=7,
                  n_identities=3)
    ours = synthetic_episode(**kwargs, **eval_synthetic.domain_hooks(domain))
    ref = jepisode(**kwargs, **domain_hooks(domain))
    assert np.array_equal(ours.frames, ref.frames)


@pytest.mark.parametrize("domain", ["A", "BC"])
def test_evaluate_matches_jax(domain):
    ours = eval_synthetic.evaluate(seed=101, domain=domain, device="cpu", **SMALL)
    ref = _jax_module("eval_synthetic").evaluate(seed=101, domain=domain, **SMALL)
    assert {k: ours[k] for k in EQUAL_KEYS} == {k: ref[k] for k in EQUAL_KEYS}
    assert abs(ours["landmark_err_interocular"]
               - ref["landmark_err_interocular"]) <= LANDMARK_TOL
    assert set(ref) < set(ours) and ours["device"] == "cpu"
    assert ours["config"] == ref["config"]
    assert set(ours["stage_s"]) == {"shots", "threads", "landmarks",
                                    "tracking", "embeddings", "clustering"}


def test_probe_matches_jax(tmp_path, capsys):
    out = tmp_path / "probe.jsonl"
    rows = probe_detector.main(["--domains=A", "--seeds=101", f"--json={out}"],
                               device="cpu")
    ours = rows[0]
    ref = _jax_module("probe_detector").probe("A", seeds=(101,))
    for key in ("domain", "seeds", "gt", "missed_at_0.5", "fp_n"):
        assert ours[key] == ref[key], key
    for key in ("real_min", "real_p5", "real_p25", "fp_max", "margin"):
        assert abs(ours[key] - ref[key]) <= SCORE_TOL, (key, ours[key], ref[key])
    assert rows[1] == {"domain": "ALL", "min_margin": ours["margin"]}
    assert len(out.read_text().splitlines()) == 2
