"""pyannote-structure CLI on PyTorch: shot / thread / scene.

Port of ``pyannote_video_tpu/cli/structure_cli.py`` with the same USAGE,
flags, defaults and output schemas.  ``thread`` runs at height 200 (the
``--height`` flag is the shot stage's), ``scene`` groups the threads of a
``thread.json`` into scenes on the host.

Run as ``pyannote-structure-torch shot <video> <output.json>`` (or
``python -m pyannote_video_tpu_torch.cli.structure_cli ...``); it runs on
the CUDA device (``main(argv, device="cpu")`` from Python runs it on the
CPU).
"""

from __future__ import annotations

from ..utils.device import DeviceLike

USAGE = """Video structure

The standard pipeline for is the following:

    shot boundary detection ==> shot threading ==> segmentation into scenes

Usage:
  pyannote-structure.py shot [options] <video> <output.json>
  pyannote-structure.py thread [options] <video> <shot.json> <output.json>
  pyannote-structure.py scene [options] <video> <thread.json> <output.json>
  pyannote-structure.py (-h | --help)
  pyannote-structure.py --version

Options:
  --ffmpeg=<ffmpeg>      Specify which `ffmpeg` to use.
  --height=<n_pixels>    Resize video frame to height <n_pixels> [default: 50].
  --window=<n_seconds>   Apply median filtering on <n_seconds> window [default: 2.0].
  --threshold=<value>    Set threshold to <value> [default: 1.0].
  --noise-floor=<value>  Additive denominator floor for shot DFD peak
                         normalisation; 0 restores the reference's bare
                         (y - median)/median rule [default: 1.0].
  --min-match=<n_match>  Set minimum number of matches to <n_match> [default: 20].
  --lookahead=<n_shots>  Look at up to <n_shots> following shots [default: 24].
  -h --help              Show this screen.
  --version              Show version.
  --verbose              Show progress.
"""


def do_shot(video, output, height=50, window=2.0, threshold=1.0,
            noise_floor=1.0, device: DeviceLike = None):
    from ..core import Timeline, dump
    from ..pipeline.shot import Shot

    shots = Shot(video, height=height, context=window, threshold=threshold,
                 noise_floor=noise_floor, device=device)
    shots = Timeline(shots)
    with open(output, "w") as fp:
        dump(shots, fp)


def do_thread(video, shots_path, output, min_match=20, lookahead=24,
              verbose=False, device: DeviceLike = None):
    from ..core import dump, load
    from ..pipeline.thread import Thread
    from ..utils.device import resolve_device

    device = resolve_device(device)
    with open(shots_path, "r") as fp:
        shots = load(fp)
    threads = Thread(video, shot=shots, lookahead=lookahead,
                     min_match=min_match, verbose=verbose, device=device)
    with open(output, "w") as fp:
        dump(threads(), fp)


def do_scene(video, threads_path, output, verbose=False):
    """Scene segmentation from threads (host only)."""
    from ..core import dump, load
    from ..pipeline.thread import scenes_from_threads

    with open(threads_path, "r") as fp:
        threads = load(fp)
    with open(output, "w") as fp:
        dump(scenes_from_threads(threads), fp)


def main(argv=None, device: DeviceLike = None):
    from .. import __version__
    from ..io.video import Video
    from ..utils.device import resolve_device
    from .args import parse

    arguments = parse(
        USAGE,
        version=f"pyannote-structure {__version__}",
        argv=argv,
        commands=["shot", "thread", "scene"],
        positionals={
            "shot": ["<video>", "<output.json>"],
            "thread": ["<video>", "<shot.json>", "<output.json>"],
            "scene": ["<video>", "<thread.json>", "<output.json>"],
        },
        defaults={
            "--ffmpeg": "",
            "--height": "50",
            "--window": "2.0",
            "--threshold": "1.0",
            "--noise-floor": "1.0",
            "--min-match": "20",
            "--lookahead": "24",
            "--verbose": None,
        },
    )

    verbose = bool(arguments["--verbose"])
    output = arguments["<output.json>"]
    if not arguments["scene"]:
        device = resolve_device(device)
    video = Video(arguments["<video>"], ffmpeg=arguments["--ffmpeg"] or None,
                  verbose=verbose)

    if arguments["shot"]:
        do_shot(video, output,
                height=int(arguments["--height"]),
                window=float(arguments["--window"]),
                threshold=float(arguments["--threshold"]),
                noise_floor=float(arguments["--noise-floor"]),
                device=device)

    if arguments["thread"]:
        do_thread(video, arguments["<shot.json>"], output,
                  min_match=int(arguments["--min-match"]),
                  lookahead=int(arguments["--lookahead"]),
                  verbose=verbose, device=device)

    if arguments["scene"]:
        do_scene(video, arguments["<thread.json>"], output, verbose=verbose)


if __name__ == "__main__":
    main()
