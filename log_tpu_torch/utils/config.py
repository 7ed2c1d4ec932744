"""YAML configs and the reflective object factory; counterpart of
log_tpu/utils/config.py.

`CfgNode` is a dict with attribute access and recursive merging:
`parent:` / `parents:` file merges, `_file_/<path>` value includes, nested
`_parent_` / `_parents_`, `_no_merge_` (replace instead of merge),
`_alias_` (one override key setting several), `_const_` (no attribute
assignment) and CLI override pairs. Files are read with the port's own
YAML reader (utils/yaml_lite.py). `load_object` builds a class named by a
dotted path; paths under `LoG.` (the reference's) or `log_tpu.` (the JAX
package's) resolve to this package.
"""
from __future__ import annotations

import argparse
import copy
import importlib
from ast import literal_eval

from . import yaml_lite


class CfgNode(dict):
    """Attribute-access dict with recursive merge."""

    def __init__(self, init_dict=None):
        init_dict = {} if init_dict is None else init_dict
        for k, v in init_dict.items():
            init_dict[k] = self._convert(v)
        super().__init__(init_dict)

    @classmethod
    def _convert(cls, v):
        if isinstance(v, dict) and not isinstance(v, CfgNode):
            node = CfgNode(dict(v))
            if "_parent_" in node:
                parent = CfgNode()
                parent.merge_from_file(node.pop("_parent_"))
                parent.merge_from_other_cfg(node)
                node = parent
            if "_parents_" in node:
                parent = CfgNode()
                for p in node.pop("_parents_"):
                    parent.merge_from_file(p)
                parent.merge_from_other_cfg(node)
                node = parent
            if node.pop("_const_", False):
                node.freeze()
            return node
        if isinstance(v, str) and v.startswith("_file_/"):
            node = CfgNode()
            node.merge_from_file(v[len("_file_/"):])
            return node
        return v

    def freeze(self):
        """`_const_: True`: the node and its children reject attribute
        assignment (dict-style sets and file merges stay allowed)."""
        object.__setattr__(self, "_frozen", True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def is_frozen(self):
        return getattr(self, "_frozen", False)

    def __getattr__(self, name):
        if name in self:
            return self[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if self.is_frozen():
            raise AttributeError(
                f"CfgNode is immutable (_const_): cannot set {name!r}")
        self[name] = self._convert(value)

    def merge_from_file(self, cfg_filename: str):
        with open(cfg_filename, "r", encoding="utf8") as f:
            cfg = yaml_lite.safe_load(f) or {}
        cfg = CfgNode(cfg)
        if "parent" in cfg:
            parent = cfg.pop("parent")
            if parent != "none":
                print(f"[Config] merge from parent file: {parent}")
                self.merge_from_file(parent)
        if "parents" in cfg:
            for parent in cfg.pop("parents"):
                print(f"[Config] merge from parent file: {parent}")
                self.merge_from_file(parent)
        self.merge_from_other_cfg(cfg)

    def merge_from_other_cfg(self, other):
        _merge_a_into_b(CfgNode(dict(other)), self)

    def merge_from_list(self, cfg_list):
        """Override pairs `key value` (dotted keys; values literal_eval'd
        where they parse, else strings)."""
        if len(cfg_list) % 2:
            raise ValueError(f"odd override list: {cfg_list}")
        alias = self.pop("_alias_", {})
        pairs = []
        for i in range(len(cfg_list) // 2):
            k, v = cfg_list[2 * i], cfg_list[2 * i + 1]
            if k in alias:
                pairs.extend((name, v) for name in alias[k])
            else:
                pairs.append((k, v))
        for key, value in pairs:
            node = self
            subkeys = key.split(".")
            for sub in subkeys[:-1]:
                if sub not in node:
                    node[sub] = CfgNode()
                node = node[sub]
            node[subkeys[-1]] = _decode_value(value)

    def clone(self):
        return copy.deepcopy(self)

    def dump(self):
        return yaml_lite.dump(_to_plain(self))

    def __str__(self):
        return self.dump()

    def get(self, key, default=None):
        return dict.get(self, key, default)


def _to_plain(node):
    if isinstance(node, dict):
        return {k: _to_plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_to_plain(v) for v in node]
    return node


def _merge_a_into_b(a: CfgNode, b: CfgNode):
    if a.pop("_no_merge_", False):
        b.clear()  # `_no_merge_: True` replaces the target node wholesale
    for k, v_a in a.items():
        if k in b and isinstance(v_a, dict) and isinstance(b[k], dict):
            _merge_a_into_b(CfgNode(dict(v_a)), b[k])
        else:
            b[k] = CfgNode._convert(v_a)


def _decode_value(value):
    if not isinstance(value, str):
        return value
    try:
        return literal_eval(value)
    except (ValueError, SyntaxError):
        return value


class Config:
    @classmethod
    def load_args(cls, argv=None, usage=None):
        """(args, cfg) from the command line: `--cfg X.yml [--device D]
        key value ...`. --device (default cuda) names the device the
        entry point runs on."""
        parser = argparse.ArgumentParser(usage=usage)
        parser.add_argument("--cfg", type=str, default="config/vis/base.yml")
        parser.add_argument("--local_rank", type=int, default=0)
        parser.add_argument("--debug", action="store_true")
        parser.add_argument("--profiler", action="store_true")
        parser.add_argument("--slurm", action="store_true")
        parser.add_argument("--device", type=str, default="cuda")
        parser.add_argument("opts", default=None, nargs="*")
        args = parser.parse_args(argv)
        return args, cls.load(filename=args.cfg, opts=args.opts or [],
                              debug=args.debug)

    @classmethod
    def load(cls, filename=None, opts=(), debug=False) -> CfgNode:
        cfg = CfgNode()
        if filename is not None:
            cfg.merge_from_file(filename)
        if len(opts) > 0:
            cfg.merge_from_list(list(opts))
        if debug:
            print("[Info] Configuration:")
            print(cfg)
        return cfg


# YAML configs name the reference's modules (LoG.*) or the JAX package's
# (log_tpu.*); both resolve to this package
_MODULE_REMAP = {"LoG.": "log_tpu_torch.", "log_tpu.": "log_tpu_torch."}


def remap_module(module_name: str) -> str:
    """The port's dotted path for a config's module string."""
    for old, new in _MODULE_REMAP.items():
        if module_name.startswith(old):
            return new + module_name[len(old):]
    return module_name


def load_object(module_name: str, module_args, **extra_args):
    """Instantiate `module_name` (a dotted class path) with module_args and
    extra_args as keyword arguments."""
    module_path, name = remap_module(module_name).rsplit(".", 1)
    module = importlib.import_module(module_path)
    return getattr(module, name)(**extra_args, **dict(module_args))


def load_object_from_cmd(cfg, opt):
    cfg = Config.load(cfg, opt)
    return load_object(cfg.module, cfg.args)
