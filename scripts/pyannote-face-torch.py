#!/usr/bin/env python
"""pyannote-face on PyTorch/CUDA: face tracking / landmarks + embeddings.

Entry-point wrapper; see pyannote_video_tpu_torch/cli/face_cli.py.
"""

from pyannote_video_tpu_torch.cli.face_cli import main

if __name__ == "__main__":
    main()
