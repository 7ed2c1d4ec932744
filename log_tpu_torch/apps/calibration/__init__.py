"""COLMAP and GPS calibration tools: `python -m
log_tpu_torch.apps.calibration.<tool>`, each with `main(argv=None)`."""
