"""log_tpu_torch must stand without JAX: the GPU machine has none.

Every module of the package is imported in a fresh interpreter, which must
then hold neither `jax` nor `log_tpu` in sys.modules. The package must also
import without nvcc or a GPU (kernels build at first launch only).
"""
import pkgutil
import subprocess
import sys
from pathlib import Path

import log_tpu_torch

REPO = Path(__file__).resolve().parent.parent


def _modules():
    names = ["log_tpu_torch"]
    for info in pkgutil.walk_packages(log_tpu_torch.__path__, "log_tpu_torch."):
        names.append(info.name)
    return names


def test_package_imports_without_jax():
    names = _modules()
    assert "log_tpu_torch.ops.rasterize_tiled" in names
    assert "log_tpu_torch.model.level_of_gaussian" in names
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'log_tpu'))\n"
        "assert not bad, bad\n"
        "from log_tpu_torch.ops import kernels\n"
        "assert kernels._lib is None\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_sources_name_no_jax():
    for path in (REPO / "log_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert not any(w.split(".")[0] in ("jax", "log_tpu")
                               for w in words[1:2]), (path, line)
