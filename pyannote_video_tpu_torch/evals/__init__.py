"""Quality harnesses of the port: ``eval_synthetic`` (the whole pipeline on
a synthetic episode with ground truth) and ``probe_detector`` (detector
score calibration across the eval render domains)."""
