"""The port's YAML reader and config system against PyYAML and the JAX
package's Config, on every file under config/."""
import glob
import math
from pathlib import Path

import pytest
import yaml

from log_tpu.utils import command as command_jax
from log_tpu.utils import config as config_jax
from log_tpu_torch.utils import command, config, yaml_lite

REPO = Path(__file__).resolve().parent.parent
YML = sorted(str(p.relative_to(REPO)) for p in REPO.glob("config/*/*.yml"))
TRAIN_YML = [p for p in YML if p.endswith("/train.yml")]


def same(a, b):
    """Equal values and equal types, through dicts and lists."""
    if type(a) is not type(b) and not (isinstance(a, dict)
                                       and isinstance(b, dict)):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def remapped(node):
    """Plain dicts and lists, module strings under the port's names."""
    if isinstance(node, dict):
        return {k: remapped(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [remapped(v) for v in node]
    if isinstance(node, str):
        return config.remap_module(node)
    return node


def test_all_configs_listed():
    assert len(YML) == 17 and len(TRAIN_YML) == 7


@pytest.mark.parametrize("path", YML)
def test_yaml_lite_matches_pyyaml(path):
    text = (REPO / path).read_text()
    want = yaml.safe_load(text)
    got = yaml_lite.safe_load(text)
    assert same(got, want)


def test_yaml_lite_scalars_and_collections():
    text = """
a: on
b: 100_000
c: 1.
d: 1e-5
e: 1.0e-5
f: [1, [2, 3], {x: 'y z', w: "q\\tr"}]
g: {}
h:
- 1
- - 2
  - 3
- k: v
  l: [a,
      b]
i: ~
j: 'it''s'  # comment
k: a#b
l: 0x1F
m: -.inf
n: off
"""
    assert same(yaml_lite.safe_load(text), yaml.safe_load(text))


@pytest.mark.parametrize("path", TRAIN_YML)
def test_config_load_matches_jax(path, monkeypatch):
    monkeypatch.chdir(REPO)
    want = config_jax.Config.load(path)
    want = command_jax.update_global_variable(want, want)
    got = config.Config.load(path)
    got = command.update_global_variable(got, got)
    assert isinstance(got, config.CfgNode)
    assert same(remapped(got), remapped(want))
    # the dump reads back equal through both readers
    text = got.dump()
    assert same(yaml.safe_load(text), config._to_plain(got))
    assert same(yaml_lite.safe_load(text), config._to_plain(got))


def test_overrides_match_jax(monkeypatch):
    """Override pairs land before the $name substitution, so the train
    dataset takes dataset.args.ext; values are literal_eval'd."""
    monkeypatch.chdir(REPO)
    opts = ["root", "output/x", "dataset.args.ext", ".png",
            "val_dataset.args.namelist", "['cam/0000', 'cam/0003']",
            "base_iter", "2", "NAIVE_STAGE.tree.loader.args.iterations", "8",
            "model.args.tree.cut_method", "flat_slice", "new.key", "1e-3"]
    cfgs = []
    for cfg_mod, cmd_mod in ((config_jax, command_jax), (config, command)):
        cfg = cfg_mod.Config.load("config/synthetic_conv/train.yml", opts)
        cfgs.append(cmd_mod.update_global_variable(cfg, cfg))
    want, got = cfgs
    assert same(remapped(got), remapped(want))
    assert got.train.dataset.args.ext == ".png"
    assert got.train.dataset.args.root == "output/x"
    assert got.val.dataset.args.namelist == ["cam/0000", "cam/0003"]
    assert got.train.stages.tree.loader.args.iterations == 8
    assert got.new.key == 1e-3 and got.base_iter == 2


def test_load_args_device(monkeypatch):
    monkeypatch.chdir(REPO)
    args, cfg = config.Config.load_args(
        ["--cfg", "config/synthetic/train.yml", "split", "val"])
    assert args.device == "cuda" and cfg.split == "val"
    args, _ = config.Config.load_args(
        ["--cfg", "config/synthetic/train.yml", "--device", "cpu"])
    assert args.device == "cpu"


def test_merge_features_match_jax(tmp_path, monkeypatch):
    """parents / _parent_ / _parents_ / _file_/ / _no_merge_ / _alias_ /
    _const_ behave as in the JAX package."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "base.yml").write_text(
        "a: 1\nnode:\n  x: 1\n  y: [1, 2]\nrep:\n  keep: 1\n  drop: 2\n")
    (tmp_path / "inc.yml").write_text("p: 3\nq: {r: 4}\n")
    (tmp_path / "other.yml").write_text("m: 5\n")
    (tmp_path / "top.yml").write_text(
        "parents:\n  - base.yml\n"
        "node:\n  y: [3]\n  z: _file_/inc.yml\n"
        "rep:\n  _no_merge_: True\n  new: 7\n"
        "sub:\n  _parent_: other.yml\n  n: 6\n"
        "subs:\n  _parents_: [other.yml, inc.yml]\n"
        "frozen:\n  _const_: True\n  v: 1\n"
        "_alias_:\n  both: [a, node.x]\n")
    opts = ["both", "9"]
    want = config_jax.Config.load("top.yml", opts)
    got = config.Config.load("top.yml", opts)
    assert same(config._to_plain(got), config_jax._to_plain(want))
    assert got.a == 9 and got.node.x == 9 and got.rep == {"new": 7}
    with pytest.raises(AttributeError):
        got.frozen.v = 2
    with pytest.raises(AttributeError):
        want.frozen.v = 2


def test_load_object_remaps_modules():
    sampler = config.load_object("LoG.utils.sampler.IndexSampler",
                                 {"index": [2, 0]}, dataset=[0, 1, 2])
    assert type(sampler).__module__ == "log_tpu_torch.utils.sampler"
    assert list(sampler) == [2, 0]
    assert config.remap_module("log_tpu.dataset.colmap.ImageDataset") == \
        "log_tpu_torch.dataset.colmap.ImageDataset"


def test_should_ignore_directory_rules():
    """Unlike the JAX package's fnmatch on file paths, a directory rule
    (build/) excludes the files under it."""
    rules = ["__pycache__/", "*.pyc", "build/", "output/", "a/b.txt"]
    assert command.should_ignore("build/x/y.so", rules)
    assert not command_jax.should_ignore("build/x/y.so", rules)
    assert command.should_ignore("pkg/__pycache__/m.cpython.pyc", rules)
    assert command.should_ignore("a/b.txt", rules)
    assert not command.should_ignore("log_tpu_torch/ops/kernels.py", rules)
    assert not command.should_ignore("buildx/y.py", rules)


def test_copy_files_skips_ignored(tmp_path):
    src = tmp_path / "src"
    for rel in ("keep.py", "pkg/mod.py", "build/lib.so", "output/x/log.txt",
                "pkg/__pycache__/mod.pyc"):
        (src / rel).parent.mkdir(parents=True, exist_ok=True)
        (src / rel).write_text("x")
    (src / ".gitignore").write_text("__pycache__/\nbuild/\n")
    dst = tmp_path / "dst"
    copied = command.copy_files(str(src), str(dst))
    rels = sorted(str(Path(p).relative_to(src)) for p in copied)
    assert rels == [".gitignore", "keep.py", "pkg/mod.py"]
    assert sorted(glob.glob(str(dst / "**" / "*"), recursive=True)) == sorted(
        str(dst / r) for r in ("keep.py", "pkg", "pkg/mod.py"))
