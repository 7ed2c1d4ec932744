"""log_tpu_torch must stand without JAX: the GPU machine has none.

The scripts (scale, dissection and probe scripts, and the benchmark) and
the stage and scene functions they call are named explicitly, so that a
renamed or missing one fails here.

Every module of the package is imported in a fresh interpreter, which must
then hold neither `jax` nor `log_tpu` in sys.modules, nor the optional host
packages `cv2`, `PIL` and `yaml` (imported only inside the JPEG and video
branches of utils/image_io.py). The package must also import without nvcc
or a GPU (kernels build at first launch only).
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
    assert "log_tpu_torch.apps.train" in names
    for name in ("comm", "mesh", "launch", "sharded_step", "executor",
                 "sharded_render"):
        assert f"log_tpu_torch.parallel.{name}" in names
    for name in ("model.base_gaussian", "model.model_utils",
                 "utils.colmap_utils", "apps.viewer", "apps.gui",
                 "apps.check_viewer", "apps.test_pointcloud",
                 "apps.test_dataset", "apps.calibration.read_colmap",
                 "apps.calibration.align_with_cam",
                 "apps.calibration.align_with_gps",
                 "apps.calibration.read_gps_info",
                 "apps.calibration.run_midas", "scripts._common",
                 "scripts.bench_trainstep", "scripts.bench_spill",
                 "scripts.bench_4k", "scripts.bench_capacity",
                 "scripts.bench_frame_dissect",
                 "scripts.bench_trainstep_dissect", "scripts.bench_kernel",
                 "scripts.bench_explore", "scripts.bench_sortcost",
                 "scripts.bench_gathercost", "scripts.bench_blockgather",
                 "scripts.backend_equivalence",
                 "scripts.check_sharded_fullscale", "scripts.bench",
                 "ops.to_host"):
        assert f"log_tpu_torch.{name}" in names
    from log_tpu_torch.model import train_step
    from log_tpu_torch.scripts import _common, bench
    from log_tpu_torch.utils import jax_random, synth_tree

    for fn in ("run", "main", "find_min_res_for_cut", "fused_cell",
               "block_cell", "block_cache", "timed_cell", "memory",
               "n_roots_bucket", "cap_sort_for", "k_vis_for", "fused_budget",
               "block_budget", "k_blocks_for"):
        assert callable(getattr(bench, fn))
    for fn in ("frame_loop", "honest_frames", "profiled", "count_syncs"):
        assert callable(getattr(_common, fn))

    for fn in ("build_scene", "pad_scene", "checkpoint_scene", "scene_tree"):
        assert callable(getattr(synth_tree, fn))
    assert "log_tpu_torch.utils.jax_random" in names
    for fn in ("prng_key", "split", "uniform", "randint", "normal",
               "np_split", "np_uniform", "np_randint", "np_normal", "np_exp"):
        assert callable(getattr(jax_random, fn))
    for fn in ("run_stages", "flat_slice_stages", "packed_frame_stages",
               "root_cull_stages", "train_step_stages", "alive_rows"):
        assert callable(getattr(train_step, fn))
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'log_tpu', 'cv2',\n"
        "                                    'PIL', 'yaml'))\n"
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
