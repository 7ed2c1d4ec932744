"""Dotted-path attribute access; counterpart of
log_tpu/model/model_utils.py."""
from __future__ import annotations


def get_module_by_str(obj, path: str):
    """obj.a.b.c for path "a.b.c", or None where a step is missing."""
    cur = obj
    for part in path.split("."):
        if not hasattr(cur, part):
            return None
        cur = getattr(cur, part)
    return cur
