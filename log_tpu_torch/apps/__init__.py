"""The port's entry points: `python -m log_tpu_torch.apps.<name>`; each has
a `main(argv=None)` that can also be called in process."""
