"""Checkpoint loading; counterpart of load_statedict in
log_tpu/utils/command.py."""
from __future__ import annotations

import pickle

import torch


def load_statedict(ckptname, map_location="cpu"):
    """Load a checkpoint: the JAX package's pickle format or a torch .pth.

    Torch zip archives start with 'PK'; the JAX package's checkpoints are
    plain pickle whatever their extension. Only load files this project
    wrote: unpickling runs code. Returns a flat key -> array dict.
    """
    with open(ckptname, "rb") as f:
        head = f.read(2)
    if head != b"PK":
        with open(ckptname, "rb") as f:
            statedict = pickle.load(f)
    else:
        statedict = torch.load(ckptname, map_location=map_location,
                               weights_only=False)
    if "state_dict" in statedict:
        statedict = statedict["state_dict"]
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in statedict.items()}
