#!/usr/bin/env python
"""pyannote-structure on PyTorch/CUDA: shot boundary detection / threading /
scenes.

Entry-point wrapper; see pyannote_video_tpu_torch/cli/structure_cli.py.
"""

from pyannote_video_tpu_torch.cli.structure_cli import main

if __name__ == "__main__":
    main()
