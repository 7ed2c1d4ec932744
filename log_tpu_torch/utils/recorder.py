"""Scalar logging to <logdir>/scalars.jsonl; counterpart of
log_tpu/utils/recorder.py (without its optional TensorBoard writer)."""
from __future__ import annotations

import json
import os
import time


class Recorder:
    """`log(step, key, val)` appends one JSON line; with logdir None every
    call is dropped (a trainer without an exp dir)."""

    def __init__(self, logdir="log"):
        self.logdir = logdir
        self._jsonl = None
        if logdir is not None:
            os.makedirs(logdir, exist_ok=True)
            self._jsonl = open(os.path.join(logdir, "scalars.jsonl"), "a")

    def log(self, step, key, val):
        if self._jsonl is None:
            return
        try:
            val = float(val)
        except (TypeError, ValueError):
            return
        self._jsonl.write(json.dumps({"t": time.time(), "step": int(step),
                                      "key": key, "val": val}) + "\n")
        self._jsonl.flush()

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
