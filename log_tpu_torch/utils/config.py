"""Reflective object factory; the load_object part of
log_tpu/utils/config.py. Config-file parsing (Config.load_args) comes
with the training slice."""
from __future__ import annotations

import importlib

# YAML configs name the reference's modules (LoG.*) or the JAX package's
# (log_tpu.*); both resolve to this package
_MODULE_REMAP = {"LoG.": "log_tpu_torch.", "log_tpu.": "log_tpu_torch."}


def load_object(module_name: str, module_args, **extra_args):
    """Instantiate `module_name` (a dotted class path) with module_args and
    extra_args as keyword arguments."""
    for old, new in _MODULE_REMAP.items():
        if module_name.startswith(old):
            module_name = new + module_name[len(old):]
            break
    module_path, name = module_name.rsplit(".", 1)
    module = importlib.import_module(module_path)
    return getattr(module, name)(**extra_args, **dict(module_args))
