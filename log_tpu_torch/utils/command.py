"""CLI helpers: `$name` substitution, checkpoint loading and the code
snapshot of a training run; counterpart of log_tpu/utils/command.py."""
from __future__ import annotations

import fnmatch
import os
import pickle
import shutil
from datetime import datetime

import torch

# directories never copied into a code snapshot: scenes, outputs and caches
# (an exp dir lives under output/, so a run never copies itself)
SNAPSHOT_SKIP_DIRS = (".git", "debug", "data", "cache", "output", "extension",
                      "submodules")


def update_global_variable(global_var, cfg):
    """Replace '$name' string values by top-level cfg keys, recursively
    through dicts (list items are left as they are)."""
    for key, val in cfg.items():
        if isinstance(val, dict):
            cfg[key] = update_global_variable(global_var, val)
        elif isinstance(val, str) and val.startswith("$"):
            print("[Config] replace key", val)
            cfg[key] = global_var[val[1:]]
    return cfg


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


def load_gitignore_rules(src_dir):
    rules = []
    try:
        with open(os.path.join(src_dir, ".gitignore"), "r") as f:
            for line in f:
                line = line.strip()
                if line and not line.startswith("#"):
                    rules.append(line)
    except FileNotFoundError:
        pass
    return rules


def should_ignore(path, rules):
    """True where a .gitignore rule matches the relative path `path`: by
    fnmatch on the whole path, as the JAX package does, and, unlike it, a
    rule naming a directory (`build/`) also matches every path inside a
    directory of that name, and a rule without a slash matches any path
    component (`__pycache__`, `*.pyc`)."""
    parts = path.replace(os.sep, "/").split("/")
    for rule in rules:
        if fnmatch.fnmatch(path, rule):
            return True
        name = rule.rstrip("/")
        if "/" in name:
            continue
        comps = parts[:-1] if rule.endswith("/") else parts
        if any(fnmatch.fnmatch(c, name) for c in comps):
            return True
    return False


def copy_files(src_dir, dst_dir):
    filenames = []
    rules = load_gitignore_rules(src_dir)
    for root, dirs, files in os.walk(src_dir, topdown=True):
        rel_root = os.path.relpath(root, src_dir)
        dirs[:] = [d for d in dirs if d not in SNAPSHOT_SKIP_DIRS
                   and not should_ignore(
                       os.path.normpath(os.path.join(rel_root, d)) + "/",
                       rules)]
        for name in files:
            file_path = os.path.join(root, name)
            rel_path = os.path.relpath(file_path, src_dir)
            if not should_ignore(rel_path, rules):
                dst_path = os.path.join(dst_dir, rel_path)
                os.makedirs(os.path.dirname(dst_path), exist_ok=True)
                shutil.copyfile(file_path, dst_path)
                filenames.append(file_path)
    return filenames


def copy_git_tracked_files(code_dir, output_base_dir):
    """Snapshot the code under code_dir into
    <output_base_dir>/code_backup_<time>; returns that directory."""
    timestamp = datetime.now().strftime("%Y%m%d-%H%M%S")
    output_dir = os.path.join(output_base_dir, f"code_backup_{timestamp}")
    os.makedirs(output_dir, exist_ok=True)
    filenames = copy_files(code_dir, output_dir)
    print(f">>> Code {len(filenames)} files has been copied to {output_dir}")
    return output_dir
