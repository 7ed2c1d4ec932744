"""The interactive viewer's entry point under the reference's name; it
serves the web viewer (a headless host has no window to draw into):

    python -m log_tpu_torch.apps.gui --cfg X.yml ckptname <ckpt> [port 8008]

See log_tpu_torch/apps/viewer.py.
"""
from __future__ import annotations

from .viewer import main

if __name__ == "__main__":
    main()
