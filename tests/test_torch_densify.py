"""The port's densification against log_tpu on the CPU: the host tree's
structural ops, the host Splitter, the device densify functions, the two
stage updates on the host and the device path, the update_by_iteration
schedule, and training steps after a densify.

The models are built as tests/test_densify_device.py builds them (a point
cloud through register_by_pointcloud, training_setup), with counters and
moments set by hand from a numpy seed; the JAX model's state_dict carries
the state across to the port. The random keep draws are injected as
`rand_u` in both packages, or drawn by each from a stream seeded alike
(test_update_init_stage_draws_match_jax).

Limits: flags, num_points, capacity, tree arrays and integer counters
exactly equal; params, moments and float counters to rtol 1e-5, atol 1e-6
(tests/test_densify_device.py's tolerances).
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from log_tpu.model import densify_device as dd_jax
from log_tpu.model.level_of_gaussian import LoG as LoGJax
from log_tpu.model.splitter import Splitter as SplitterJax
from log_tpu.model.tensor_tree import TensorTree as TensorTreeJax
from log_tpu_torch.model import densify_device as dd
from log_tpu_torch.model.counter import COUNTER_KEYS
from log_tpu_torch.model.gaussian import next_capacity
from log_tpu_torch.model.level_of_gaussian import LoG
from log_tpu_torch.model.splitter import Splitter
from log_tpu_torch.model.tensor_tree import TensorTree

KEYS = ("xyz", "colors", "scaling", "opacity", "rotation", "shs")
TREE_KEYS = ("root_index", "tree", "node_index", "index_parent",
             "local_index", "depth", "root_id")
# model.args of config/synthetic/level_of_gaussian.yml without init_ply
CFG = {
    "gaussian": {"sh_degree": 1, "xyz_scale": 1.0},
    "tree": {"max_child": 4, "max_level": 30},
    "optimizer": {
        "optimize_keys": list(KEYS), "opt_all_levels": True,
        "lr_dict": {"xyz": 0.00016, "xyz_final": 0.0000016, "colors": 0.0025,
                    "shs": 0.000125, "scaling": 0.005, "opacity": 0.05,
                    "rotation": 0.001, "max_steps": 600},
    },
    "densify_and_remove": {
        "upgrade_sh_iter": 10, "densify_from_iter": 1, "densify_every_iter": 1,
        "upgrade_repeat": 2, "init_split_method": "split_by_2d",
        "init_radius_min": 4, "init_radius_split": 16, "init_weight_min": 0.1,
        "min_steps": 50, "method": "naive", "split_grad_thres": 0.0002,
        "radius2d_thres": 6, "remove_weights_thres": 0.005,
        "max_split_points": 20000, "sort_method": "radii",
        "min_steps_split": 100, "scaling_decay": 0.9,
    },
}
N_POINTS = 200  # capacity 256


def _cfg():
    return copy.deepcopy(CFG)


def _jax_model(n=N_POINTS, seed=0):
    """log_tpu's model as tests/test_densify_device.py builds it."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-3, 3, n), rng.uniform(-3, 3, n),
                    rng.uniform(0, 1, n)], axis=1).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    d, _ = cKDTree(xyz).query(xyz, k=4)
    scales = np.sqrt(np.maximum(np.mean(d[:, 1:] ** 2, axis=1), 1e-7))
    model = LoGJax(**_cfg())
    model.gaussian.register_by_pointcloud(xyz, colors,
                                          scales.astype(np.float32),
                                          init_opacity=0.5)
    model.counter.reset(model.num_points, model.capacity)
    model.counter.set_numpy(
        {"radius3d_min": np.full(n, 1e-4, np.float32),
         "radius3d_max": np.full(n, 1.0, np.float32)}, model.capacity)
    model.base_iter = 10
    model.training_setup()
    # moments from the seed (second moments positive), so that their move
    # is checked
    shapes = {k: np.asarray(v).shape[1:]
              for k, v in model.optimizer.moments["exp_avg"].items()}
    mom = {"exp_avg": {k: 1e-3 * rng.normal(size=(n,) + s)
                       for k, s in shapes.items()},
           "exp_avg_sq": {k: 1e-6 * rng.uniform(size=(n,) + s)
                          for k, s in shapes.items()}}
    mom = {mk: {k: v.astype(np.float32) for k, v in d.items()}
           for mk, d in mom.items()}
    model.optimizer.set_numpy(mom, model.capacity)
    return model


def _set_counters(model, seed, split_rows=None, **fixed):
    """Counters from a numpy seed (every field), then `fixed` overrides;
    split_rows: rows given a large 2D radius and gradient."""
    rng = np.random.default_rng(seed)
    n = model.num_points
    cnt = {
        "weights_max": rng.uniform(0, 1, n).astype(np.float32),
        "weights_sum": rng.uniform(0, 3, n).astype(np.float32),
        "grad_sum": rng.uniform(0, 0.01, n).astype(np.float32),
        "radii_max": rng.integers(0, 40, n).astype(np.int32),
        "visible_count": rng.integers(0, 8, n).astype(np.int32),
        "radii_max_max": rng.integers(0, 300, n).astype(np.int32),
        "area_sum": rng.integers(0, 5, n).astype(np.int32),
        "radius3d_min": rng.uniform(1e-4, 1e-3, n).astype(np.float32),
        "radius3d_max": rng.uniform(0.5, 1.0, n).astype(np.float32),
        "create_steps": rng.integers(0, 200, n).astype(np.int32),
    }
    if split_rows is not None:
        cnt["radii_max_max"][split_rows] = rng.integers(300, 2000,
                                                        len(split_rows))
        cnt["grad_sum"][split_rows] = 100.0
        cnt["area_sum"][split_rows] = 1
        cnt["create_steps"][split_rows] = 1000
    for key, val in fixed.items():
        cnt[key] = np.broadcast_to(np.asarray(val, cnt[key].dtype), (n,)).copy()
    model.counter.set_numpy(cnt, model.capacity)


def _carry(ref, device_densify):
    """The port's model loaded from the JAX model's state_dict."""
    ref.densify_and_remove["device_densify"] = device_densify
    port = LoG(**_cfg(), device="cpu")
    port.base_iter = ref.base_iter
    port.densify_and_remove["device_densify"] = device_densify
    port.load_state_dict(ref.state_dict(), split="train")
    port.set_state(current_depth=ref.current_depth)
    return port


def _close(got, want, msg):
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=msg)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=msg)


def _assert_models_equal(port, ref):
    assert port.num_points == ref.num_points
    assert port.capacity == ref.capacity
    n = ref.num_points
    for key in TREE_KEYS:
        np.testing.assert_array_equal(getattr(port.tree, key),
                                      getattr(ref.tree, key), err_msg=key)
    for key in KEYS:
        _close(port.gaussian.get(key)[:n].numpy(),
               np.asarray(ref.gaussian.get(key))[:n], f"params[{key}]")
        for mk in ("exp_avg", "exp_avg_sq"):
            _close(port.optimizer.moments[mk][key][:n].numpy(),
                   np.asarray(ref.optimizer.moments[mk][key])[:n],
                   f"{mk}[{key}]")
    for key in COUNTER_KEYS:
        _close(port.counter.data[key][:n].numpy(),
               np.asarray(ref.counter.data[key])[:n], f"counter[{key}]")


# ----------------------------------------------------------- tree operations
def test_tree_split_and_remove_matches_jax():
    rng = np.random.default_rng(3)
    port, ref = TensorTree(max_child=4, max_level=3), TensorTreeJax(
        max_child=4, max_level=3)
    for t in (port, ref):
        t.initialize(40)
    for round_ in range(4):
        n = ref.num_points
        flag_split = rng.uniform(size=n) < 0.15
        flag_remove = rng.uniform(size=n) < 0.2
        got = port.split_and_remove(flag_split.copy(), flag_remove.copy())
        want = ref.split_and_remove(flag_split.copy(), flag_remove.copy())
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        for key in TREE_KEYS:
            np.testing.assert_array_equal(getattr(port, key),
                                          getattr(ref, key),
                                          err_msg=f"round {round_} {key}")
    assert int(ref.depth.max()) == 3  # max_level held
    # the bare ops, once more: a split, then a remove of leaves
    leaves = np.flatnonzero(ref.is_leaf)[:5]
    port.split(leaves)
    ref.split(leaves)
    removed = np.flatnonzero(ref.is_leaf & ~ref.is_root)[::3]
    port.remove(removed)
    ref.remove(removed)
    for key in TREE_KEYS:
        np.testing.assert_array_equal(getattr(port, key), getattr(ref, key))


# ------------------------------------------------------------------ splitter
@pytest.mark.parametrize("method", ["uniform", "sample"])
def test_splitter_matches_jax(method):
    rng = np.random.default_rng(4)
    n = 50
    q = rng.normal(size=(n, 4))
    arrays = {
        "xyz": rng.normal(size=(n, 3)).astype(np.float32),
        "scaling": np.log(rng.uniform(0.05, 0.5, (n, 3))).astype(np.float32),
        "rotation": (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(
            np.float32),
        "colors": rng.normal(size=(n, 3)).astype(np.float32),
    }
    flag_split = rng.uniform(size=n) < 0.3
    flag_remove = rng.uniform(size=n) < 0.2
    moments = {mk: {k: rng.normal(size=v.shape).astype(np.float32)
                    for k, v in arrays.items()}
               for mk in ("exp_avg", "exp_avg_sq")}
    cnt = {"create_steps": rng.integers(0, 9, n).astype(np.int32),
           "radius3d_min": rng.uniform(size=n).astype(np.float32),
           "radius3d_max": rng.uniform(size=n).astype(np.float32)}
    from log_tpu_torch.model.activation import Activation
    from log_tpu.model.activation import Activation as ActivationJax

    for remove_split in (True, False):
        got = Splitter(N=4, split_method=method).split_and_remove(
            arrays, Activation("exp"), flag_split, flag_remove,
            remove_split=remove_split, rng=np.random.default_rng(9))
        want = SplitterJax(N=4, split_method=method).split_and_remove(
            arrays, ActivationJax("exp"), flag_split, flag_remove,
            remove_split=remove_split, rng=np.random.default_rng(9))
        assert got[1:] == want[1:]
        for key in arrays:
            np.testing.assert_array_equal(got[0][key], want[0][key])
        got_m = Splitter(N=4).split_and_remove_moments(
            moments, flag_split, flag_remove, remove_split=remove_split)
        want_m = SplitterJax(N=4).split_and_remove_moments(
            moments, flag_split, flag_remove, remove_split=remove_split)
        got_o = Splitter(N=4).split_and_remove_other(
            cnt, list(cnt), flag_split, flag_remove, remove_split=remove_split)
        want_o = SplitterJax(N=4).split_and_remove_other(
            cnt, list(cnt), flag_split, flag_remove, remove_split=remove_split)
        for mk in moments:
            for key in arrays:
                np.testing.assert_array_equal(got_m[mk][key], want_m[mk][key])
        for key in cnt:
            np.testing.assert_array_equal(got_o[key], want_o[key])


# ------------------------------------------------- device densify functions
def _device_inputs(seed=7):
    """A capacity-padded model state (both packages' dtypes) from a seed:
    params, counter and tree arrays; rows 180-255 are dead."""
    ref = _jax_model(180, seed=seed)
    _set_counters(ref, seed, split_rows=np.arange(0, 180, 7))
    params = {k: np.array(v) for k, v in ref.gaussian.params().items()}
    counter = {k: np.array(v) for k, v in ref.counter.data.items()}
    rng = np.random.default_rng(seed)
    cap = ref.capacity
    tree = {"node_index": np.where(rng.uniform(size=cap) < 0.7, -1,
                                   rng.integers(0, 50, cap)).astype(np.int32),
            "depth": rng.integers(0, 4, cap).astype(np.int32)}
    rand_u = rng.uniform(size=(2, cap)).astype(np.float32)
    return ref.num_points, params, counter, tree, rand_u


def _t(d):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


@pytest.mark.parametrize("mode", ["split_by_2d", "split_by_3d"])
def test_init_stage_flags_match_jax(mode):
    n, params, counter, _, rand_u = _device_inputs()
    # 3d: a few rows past 0.1 x xyz_scale, a few below 0.005
    params["scaling"][:12] = np.log(0.2)
    params["scaling"][12:30] = np.log(0.003)
    args = (2.0, 1.0, 0.1, 4.0, 16.0, 50, 0.0002)
    got = dd.init_stage_flags(_t(params), _t(counter), n,
                              torch.from_numpy(rand_u), *args, mode=mode)
    want = dd_jax.init_stage_flags(
        _j(params), _j(counter), jnp.int32(n), jnp.asarray(rand_u),
        *(jnp.float32(a) for a in args[:5]), jnp.int32(args[5]),
        jnp.float32(args[6]), mode=mode)
    for a, b, name in zip(got[:3], want[:3], ("split", "remove", "reset")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    for key in want[3]:
        assert int(got[3][key]) == int(want[3][key]), key
    assert int(got[3]["n_split"]) > 0 and int(got[3]["n_remove"]) > 0


def test_init_stage_flags_keep_guard_matches_jax():
    """Nearly every row fails the weight test: the 16 top-weight rows are
    kept, ties taken from the lower row as jax.lax.top_k takes them."""
    n, params, counter, _, rand_u = _device_inputs()
    counter["weights_max"][:] = 0.01
    counter["weights_max"][40:48] = 0.5
    got = dd.init_stage_flags(_t(params), _t(counter), n,
                              torch.from_numpy(rand_u), 1.0, 1.0, 0.1, 4.0,
                              16.0, 50, 0.0002)
    want = dd_jax.init_stage_flags(
        _j(params), _j(counter), jnp.int32(n), jnp.asarray(rand_u),
        jnp.float32(1), jnp.float32(1), jnp.float32(0.1), jnp.float32(4),
        jnp.float32(16), jnp.int32(50), jnp.float32(0.0002))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[3]["n_remove"]) == n - 16


@pytest.mark.parametrize("sort_method", ["radii", "opacity", "grad"])
def test_depth_stage_flags_match_jax(sort_method):
    n, params, counter, tree, _ = _device_inputs()
    counter["create_steps"][:] = 1000
    args = (20, 100, 0.0002, 6, 0.3, 20000)
    got = dd.depth_stage_flags(_t(params), _t(counter), _t(tree), n, *args,
                               sort_method=sort_method)
    want = dd_jax.depth_stage_flags(
        _j(params), _j(counter), _j(tree), jnp.int32(n), jnp.int32(args[0]),
        jnp.int32(args[1]), jnp.float32(args[2]), jnp.int32(args[3]),
        jnp.float32(args[4]), jnp.int32(args[5]), sort_method=sort_method)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert bool(got[2]["over"]) and bool(want[2]["over"])  # the top-K cap
    assert int(got[2]["n_split"]) == int(want[2]["n_split"]) > 0
    assert float(got[2]["thres"]) == float(want[2]["thres"])


@pytest.mark.parametrize("remove_split", [True, False])
def test_rebuild_split_remove_matches_jax(remove_split):
    n, params, counter, _, rand_u = _device_inputs()
    rng = np.random.default_rng(8)
    cap = params["xyz"].shape[0]
    alive = np.arange(cap) < n
    flag_split = (rng.uniform(size=cap) < 0.1) & alive
    flag_remove = (rng.uniform(size=cap) < 0.2) & alive & ~flag_split
    mom = {mk: {k: rng.normal(size=v.shape).astype(np.float32)
                for k, v in params.items()} for mk in ("exp_avg", "exp_avg_sq")}
    n_split = int(flag_split.sum())
    n_keep = n - int(flag_remove.sum()) - (n_split if remove_split else 0)
    new_cap = next_capacity(n_keep + 4 * n_split)
    kw = dict(new_cap=new_cap, s_cap=next_capacity(n_split, 256), n_child=4,
              remove_split=remove_split, keys=KEYS)
    fill = 0.2 if remove_split else -1.0
    got = dd.rebuild_split_remove(
        _t(params), {mk: _t(v) for mk, v in mom.items()}, _t(counter),
        torch.from_numpy(flag_split), torch.from_numpy(flag_remove), n,
        scaling_decay=0.9, radius3d_max_fill=fill, **kw)
    want = dd_jax.rebuild_split_remove(
        _j(params), {mk: _j(v) for mk, v in mom.items()}, _j(counter),
        jnp.asarray(flag_split), jnp.asarray(flag_remove), jnp.int32(n),
        scaling_decay=jnp.float32(0.9), radius3d_max_fill=fill, **kw)
    new_n = n_keep + 4 * n_split
    assert int(got[3]) == int(want[3]) and int(got[4]) == int(want[4])
    assert int(got[3]) + int(got[4]) == new_n
    for key in KEYS:
        _close(got[0][key][:new_n].numpy(), np.asarray(want[0][key])[:new_n],
               key)
        for mk in mom:
            _close(got[1][mk][key].numpy(), np.asarray(want[1][mk][key]),
                   f"{mk}.{key}")
    for key in COUNTER_KEYS:
        _close(got[2][key].numpy(), np.asarray(want[2][key]), key)


def test_bisect_takes_the_first_of_equal_scales():
    """A fresh point-cloud point repeats one scale on all three axes: the
    split runs along the first axis in the port, numpy and jnp alike."""
    from log_tpu.model.densify_device import _bisect_once as bisect_jax
    from log_tpu_torch.model.splitter import _bisect_longest_axis

    rng = np.random.default_rng(2)
    xyz = rng.normal(size=(6, 3)).astype(np.float32)
    scaling = np.repeat(rng.uniform(0.1, 0.3, (6, 1)), 3, axis=1).astype(
        np.float32)
    q = rng.normal(size=(6, 4))
    rot = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    got = dd._bisect_once(*(torch.from_numpy(a) for a in (xyz, scaling, rot)))
    want = bisect_jax(*(jnp.asarray(a) for a in (xyz, scaling, rot)))
    host = _bisect_longest_axis(xyz, scaling, rot)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(got[0].numpy(), host[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), host[1], rtol=1e-6)
    # the first axis was halved, the other two kept
    np.testing.assert_array_equal(got[1][:, 0].numpy(),
                                  np.repeat(scaling[:, 0] * 0.5, 2))
    np.testing.assert_array_equal(got[1][:, 1:].numpy(),
                                  np.repeat(scaling[:, 1:], 2, axis=0))


# ------------------------------------------------------------- stage updates
@pytest.mark.parametrize("path", ["off", "on"])
@pytest.mark.parametrize("mode", ["split_by_2d", "split_by_3d"])
def test_update_init_stage_matches_jax(path, mode):
    """Enough rows split to pass capacity 256 (the next bucket)."""
    ref = _jax_model()
    n = ref.num_points
    _set_counters(ref, 11, split_rows=np.arange(0, n, 5))
    if mode == "split_by_3d":
        arrays = {k: np.array(v)[:n] for k, v in ref.gaussian.params().items()}
        arrays["scaling"][::5] = np.log(0.2)
        arrays["scaling"][1::9] = np.log(0.003)
        ref.gaussian.set_numpy(arrays)
        ref._refresh_device_caches()
    ref.densify_and_remove["init_split_method"] = mode
    port = _carry(ref, path)
    port.densify_and_remove["init_split_method"] = mode
    rand_u = np.random.default_rng(12).uniform(size=(2, n)).astype(np.float32)
    ref.update_init_stage(scale=1, rand_u=rand_u.copy())
    port.update_init_stage(scale=1, rand_u=rand_u.copy())
    _assert_models_equal(port, ref)
    if mode == "split_by_2d":
        assert port.capacity == next_capacity(port.num_points) > 256
    assert port._bucket is None and port._render_bucket is None


@pytest.mark.parametrize("path", ["off", "on"])
def test_update_init_stage_draws_match_jax(path):
    """No rand_u: each model draws its keep mask from its own densify
    stream, seeded alike: the host path draws the uniforms from it, the
    device path the key of its jax.random.uniform (utils/jax_random.py in
    the port); both streams end in the same state."""
    ref = _jax_model()
    n = ref.num_points
    _set_counters(ref, 11, split_rows=np.arange(0, n, 5))
    port = _carry(ref, path)
    ref._rng = np.random.default_rng(1234)
    port._rng = np.random.default_rng(1234)
    ref.update_init_stage(scale=1)
    port.update_init_stage(scale=1)
    _assert_models_equal(port, ref)
    assert port.num_points != n  # the draws kept, split and removed rows
    assert port._rng.bit_generator.state == ref._rng.bit_generator.state


def test_gradmean_matches_jax():
    """Counter.get_gradmean on the same counters: grad_sum / max(area_sum,
    1), float64 on the host, equal."""
    ref = _jax_model()
    _set_counters(ref, 5)
    port = _carry(ref, "off")
    got, want = port.counter.get_gradmean(), ref.counter.get_gradmean()
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got[:ref.num_points],
                                  want[:ref.num_points])
    assert (np.asarray(ref.counter.area_sum)[:ref.num_points] == 0).any()


@pytest.mark.parametrize("path", ["off", "on"])
def test_update_depth_stage_matches_jax(path):
    ref = _jax_model()
    ref.upgrade_tree()
    n = ref.num_points
    _set_counters(ref, 13, split_rows=np.arange(0, n, 3),
                  create_steps=1000, weights_max=1.0)
    port = _carry(ref, path)
    ref.update_depth_stage(0)
    port.update_depth_stage(0)
    assert port.num_points > n  # the top-K cap: 10 parents split
    _assert_models_equal(port, ref)


@pytest.mark.parametrize("path", ["off", "on"])
def test_update_depth_stage_with_removal_matches_jax(path):
    """A second depth densify removes low-weight children of the first."""
    ref = _jax_model()
    ref.upgrade_tree()
    n0 = ref.num_points
    _set_counters(ref, 13, split_rows=np.arange(0, n0, 3),
                  create_steps=1000, weights_max=1.0)
    ref.densify_and_remove["device_densify"] = "off"
    ref.update_depth_stage(0)
    n1 = ref.num_points
    wmax = np.ones(n1, np.float32)
    wmax[-12:] = 1e-6  # children sit at the end
    _set_counters(ref, 14, split_rows=np.arange(0, n0, 4), create_steps=1000,
                  visible_count=5)
    ref.counter.set_numpy({"weights_max": wmax}, ref.capacity)
    port = _carry(ref, path)
    ref.update_depth_stage(1)
    port.update_depth_stage(1)
    assert (port.tree.depth > 0).sum() < (n1 - n0) + 4 * 10
    _assert_models_equal(port, ref)


# ------------------------------------------------------------------ schedule
def _record_schedule(model, events):
    """Patch the stage updates to record (iteration, action) and run
    nothing; upgrade_tree and counter resets record and run."""
    now = {"it": None}
    real_upgrade = model.upgrade_tree
    real_reset = model.counter.reset

    def upgrade():
        events.append((now["it"], "upgrade_tree"))
        real_upgrade()

    def reset(*args, **kwargs):
        if now["it"] is not None:
            events.append((now["it"], "reset"))
        real_reset(*args, **kwargs)

    model.update_init_stage = lambda scale=1, rand_u=None: events.append(
        (now["it"], f"init_densify scale={scale}"))
    model.update_depth_stage = lambda g: events.append(
        (now["it"], f"depth_densify {g}"))
    model.upgrade_tree = upgrade
    model.counter.reset = reset
    return now


def _run_schedule(model):
    """Stages init (4 x 20) and tree (6 x 20) of config/synthetic/train.yml
    at base_iter 20, as log_tpu/utils/trainer.py drives them."""
    model.base_iter = 20
    events, due = [], []
    now = _record_schedule(model, events)
    global_it = 0
    for stage, n_iter, state in (("init", 80, {}), ("tree", 120,
                                                    {"enable_sh": True})):
        model.set_stage(stage)
        model.set_state(**state)
        model.training_setup()
        for it in range(n_iter):
            due.append(model.densify_due(it))
            if it + 1 < n_iter:
                now["it"] = (stage, it)
                model.update_by_iteration(it, global_it)
                now["it"] = None
            global_it += 1
    return events, due


def test_update_by_iteration_schedule_matches_jax():
    ref = _jax_model()
    port = _carry(ref, "auto")
    got, got_due = _run_schedule(port)
    want, want_due = _run_schedule(ref)
    assert got == want
    assert got_due == want_due
    assert [e for e in got if e[1] != "reset" or e[0][1] != 39] == [
        (("init", 19), "reset"), (("init", 39), "init_densify scale=1"),
        (("init", 59), "init_densify scale=1"), (("tree", 19), "reset"),
        (("tree", 39), "upgrade_tree"), (("tree", 59), "reset"),
        (("tree", 79), "depth_densify 159"), (("tree", 99), "reset"),
    ]
    assert port.current_depth == ref.current_depth == 20


# ------------------------------------------------ training after a densify
def test_training_after_device_densify():
    """Two training_iteration calls after a device densify that moved the
    capacity: the step bucket is rebuilt and the state stays finite."""
    from log_tpu_torch.dataset.base import prepare_camera

    ref = _jax_model()
    n = ref.num_points
    _set_counters(ref, 11, split_rows=np.arange(0, n, 5))
    port = _carry(ref, "on")
    port.update_init_stage(
        rand_u=np.random.default_rng(12).uniform(size=(2, n)))
    assert port.capacity > 256 and port._bucket is None
    pos = np.array([0.0, -9.0, 6.0])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, [0, 0, 1.0])
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    cam = prepare_camera({"K": np.array([[60.0, 0, 64], [0, 60.0, 32],
                                         [0, 0, 1]]),
                          "R": R, "T": (-R @ pos).reshape(3, 1), "H": 64,
                          "W": 128, "center": pos.reshape(3, 1)},
                         1, 0.01, 100.0)
    gt = np.random.default_rng(1).integers(0, 256, (3, 64, 128),
                                           dtype=np.uint8)
    for _ in range(2):
        met, _ = port.training_iteration(cam, gt, np.zeros(3, np.float32))
        assert np.isfinite(float(met["loss"]))
    assert port._bucket is not None and port._bucket[0] <= port.capacity
    for d in (port.gaussian.params(), port.optimizer.moments["exp_avg"],
              port.optimizer.moments["exp_avg_sq"]):
        for key, val in d.items():
            assert val.shape[0] == port.capacity, key
            assert torch.isfinite(val).all(), key
    assert int((port.counter.data["visible_count"] > 0).sum()) > 50
