#!/usr/bin/env python3
"""The streaming engines of ``pyannote-face`` beside the older ones, on one GPU.

Run from the repository root: ``python3 scripts/stream_ab.py [--out FILE]``.
On ``chip_smoke.py``'s 1280x720 episode (10 shots x 32 frames) it runs
``face_cli.track`` and then ``face_cli.extract`` by the older engine
(``PYV_NO_STREAM=1``), the streaming one, the streaming one and the older
one again, after one warm-up run of each, so that the two engines are
compared within one process on one card.  Per run: wall seconds, and for
the streaming engine its ``StreamLegs``; for ``track`` also the seconds per
scan step (``TrackingByDetection._track_passes``).  Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stream_ab: no CUDA device", file=sys.stderr)
        return 2

    import chip_smoke
    from pyannote_video_tpu_torch.cli.face_cli import extract, track
    from pyannote_video_tpu_torch.cli.structure_cli import do_shot
    from pyannote_video_tpu_torch.io.video import Video
    from pyannote_video_tpu_torch.pipeline.streaming import StreamLegs
    from pyannote_video_tpu_torch.pipeline.tracking import TrackingByDetection

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    frames, fps, _, _, _ = chip_smoke.make_episode()
    steps = 2 * len(frames)
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "frames": len(frames), "size": [1280, 720],
              "order": ["older", "streaming", "streaming", "older"],
              "track": [], "extract": []}

    with tempfile.TemporaryDirectory() as tmp:
        shot_json, tracking = f"{tmp}/shot.json", f"{tmp}/tracking.txt"
        do_shot(Video(frames, fps=fps), shot_json, threshold=2.0, device="cuda")

        def run_track(streaming: bool) -> dict:
            legs = StreamLegs()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with chip_smoke.stopwatch(TrackingByDetection, "_track_passes") as spent:
                track(Video(frames, fps=fps), shot_json, tracking,
                      detect_every=chip_smoke.DETECT_EVERY, legs=legs,
                      device="cuda")
            row = {"engine": "streaming" if streaming else "per-shot",
                   "seconds": time.perf_counter() - t0,
                   "scan_ms_per_step": spent["_track_passes"] / steps * 1e3}
            if streaming:
                row["legs"] = legs.as_dict()
            return row

        def run_extract(streaming: bool) -> dict:
            legs, spent = StreamLegs(), {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            extract(Video(frames, fps=fps), "", "", tracking,
                    f"{tmp}/landmarks.txt", f"{tmp}/embeddings.txt", legs=legs,
                    device="cuda", stats=spent)
            row = {"engine": "streaming" if streaming else "chunked",
                   "seconds": time.perf_counter() - t0,
                   "load_models_s": spent["load"]}
            if streaming:
                row["legs"] = legs.as_dict()
            return row

        for name, run in (("track", run_track), ("extract", run_extract)):
            for streaming in (False, True, False, True, True, False):
                if streaming:
                    row = run(True)
                else:
                    with chip_smoke.older_engines():
                        row = run(False)
                result[name].append(row)
            # the first run of each engine was its warm-up
            result[name] = result[name][2:]

    text = json.dumps(result)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
