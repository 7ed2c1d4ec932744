"""The port's multi-device training layer (log_tpu_torch/parallel) on the
CPU, in gloo process groups started by parallel/launch.py.

  (a) the sharded step at 4 ranks against log_tpu's sharded_train_step on
      4 of the 8 virtual CPU devices, from one model built by log_tpu and
      loaded with the port's load_state_dict;
  (b) 1 rank x 4 cameras equals 4 ranks x 1 camera (the collectives change
      nothing);
  (c) the sharded step at 4 ranks, one real camera padded to the batch,
      against the port's single-device LoG.train_step over 5 steps;
  (d) the bytes each rank hands to each collective in one
      ShardedExecutor.step at 4 ranks equal wire_bytes' formula from the
      shapes (capacity, batch, slice bucket, packed columns);
  (e) ShardedExecutor's refresh_from_model -> sync_to_model round trip is
      exact, a densify between steps at 2 ranks leaves both ranks' models
      equal, and a rank whose model differs makes the refresh raise;
  (f) make_mesh factors n ranks as log_tpu's make_mesh does, and
      initialize_distributed is a no-op without its variables;
  (g) the Trainer with train.parallel.enable on at 2 ranks fits a tiny
      config through the port's CLI; only rank 0 writes the exp dir.

Tolerances of (a) and (c) are tests/test_parallel.py's
test_sharded_matches_fused_single_chip; of (b) its test_sharded_n1_equals_n4.
Rotations are compared as unit quaternions (their norm is a null space of
the loss). JAX is imported only inside the tests that compare with it; the
ranks never import it. Every launch has a 120 s limit.
"""
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from log_tpu_torch.dataset.base import prepare_camera
from log_tpu_torch.dataset.synthetic import SyntheticDataset, ring_cameras
from log_tpu_torch.parallel import mesh
from log_tpu_torch.parallel.launch import spawn

REPO = Path(__file__).resolve().parent.parent
H, W = 48, 64
TIMEOUT_S = 120
STEPS_A, STEPS_C = 3, 5
K_A = (256, 512)  # the fixed bucket of (a) and (b)
LR_DICT = {"xyz": 0.00016, "xyz_final": 0.0000016, "xyz_scale": 1.0,
           "colors": 0.0025, "shs": 0.000125, "scaling": 0.005,
           "opacity": 0.05, "rotation": 0.001, "max_steps": 600}
MODEL_ARGS = {
    "tree": {"max_child": 4, "max_level": 30},
    "optimizer": {"optimize_keys": ["xyz", "colors", "scaling", "opacity",
                                    "rotation", "shs"],
                  "opt_all_levels": True, "lr_dict": LR_DICT},
    "densify_and_remove": {
        "upgrade_sh_iter": 10, "densify_from_iter": 1,
        "densify_every_iter": 1, "upgrade_repeat": 50,
        "init_split_method": "split_by_2d", "init_radius_min": 4,
        "init_radius_split": 16, "init_weight_min": 0.1, "min_steps": 50,
        "method": "naive", "split_grad_thres": 0.0002,
        "radius2d_thres": 6, "remove_weights_thres": 0.005,
        "max_split_points": 20000, "sort_method": "radii",
        "min_steps_split": 100, "scaling_decay": 0.9,
    },
}
COUNT_EXACT = ("visible_count", "create_steps", "area_sum")
COUNT_CLOSE = ("weights_max", "weights_sum", "grad_sum")


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    monkeypatch.delenv("LOG_TPU_BACKEND", raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cameras(n=6):
    return [prepare_camera(c, 1, 0.01, 100.0) for c in ring_cameras(n, H, W)]


def _port_model(state, device="cpu"):
    """The port's LoG with the JAX-built model's state (current_depth 20,
    as upgrade_tree leaves it)."""
    from log_tpu_torch.model.level_of_gaussian import LoG

    model = LoG(gaussian={"sh_degree": 1, "xyz_scale": 1.0}, device=device,
                **MODEL_ARGS)
    model.load_state_dict(state, split="train")
    model.current_depth = 20
    return model


def _global_state(model):
    """Copies of the model's capacity-padded state, its tree arrays and
    leaf mask (what sharded_train_step takes)."""
    params = {k: v.clone() for k, v in model.gaussian.params().items()}
    moments = {mk: {k: v.clone() for k, v in d.items()}
               for mk, d in model.optimizer.moments.items()}
    counter = {k: v.clone() for k, v in model.counter.data.items()}
    cap = model.capacity
    tree_rep = model.tree.device_arrays(cap, model.device)
    leaf = (model.tree.node_index == -1) & (model.tree.depth > 0)
    pad = np.zeros((cap,), bool)
    pad[: leaf.shape[0]] = leaf
    return params, moments, counter, tree_rep, torch.from_numpy(pad)


def _run_port(model, cams, gts, steps, k, cams_per_device, real_per_step,
              comm):
    """`steps` sharded steps cycling through the cameras, as
    tests/test_parallel.py's _run_sharded; returns numpy state and losses."""
    from log_tpu_torch.parallel.executor import stack_cameras
    from log_tpu_torch.parallel.sharded_step import (ShardedStepConfig,
                                                     sharded_train_step)

    params, moments, counter, tree_rep, is_leaf_opt = _global_state(model)
    B = comm.world * cams_per_device
    cfg = ShardedStepConfig(
        image_height=H, image_width=W, k_leaf=k[0], k_node=k[1],
        sh_degree=model.gaussian.active_sh_degree, n_devices=comm.world,
        cams_per_device=cams_per_device, backend="reference",
        prep_backend="reference", stage_has_tree=True,
        num_levels=int(model.tree.depth.max()) + 1, max_pairs=1 << 16,
        prep_max_pairs=1 << 16)
    corr = {"values": torch.ones((1, 3)), "m1": torch.zeros((1, 3)),
            "m2": torch.zeros((1, 3)), "vmax": torch.zeros((1, 3)),
            "steps": torch.zeros((1,), dtype=torch.int32)}
    losses = []
    for s in range(steps):
        sel = [(s * real_per_step + j) % len(cams)
               for j in range(real_per_step)]
        sel += [sel[0]] * (B - real_per_step)
        weight = torch.zeros(B)
        weight[:real_per_step] = 1.0
        mats, scalars, centers = stack_cameras([cams[i] for i in sel])
        gt = torch.from_numpy(np.stack([gts[i] for i in sel]))
        params, moments, counter, corr, metrics, _ = sharded_train_step(
            params, moments, counter, tree_rep, is_leaf_opt,
            model.num_points, model.current_depth,
            torch.full((B,), float(model.tree.min_resolution_pixel),
                       dtype=torch.float64),
            torch.from_numpy(mats), torch.from_numpy(scalars),
            torch.from_numpy(centers), torch.zeros((B, 3)), gt, weight,
            model.optimizer.lrs_for_step(s + 1), s + 1, corr,
            torch.zeros((B,), dtype=torch.int64), cfg, comm)
        losses.append(float(metrics["loss"]))

    def host(d):
        return {k: v.numpy() for k, v in d.items()}

    return {"params": host(params),
            "moments": {mk: host(m) for mk, m in moments.items()},
            "counter": host(counter), "losses": losses}


def _wire_step(model, cams, gts, comm):
    """(d) ShardedExecutor.step twice over the first cameras; the bytes
    each collective was handed in the second (the first seeds the slice
    bucket and gathers the state once), with the shapes it ran at."""
    from log_tpu_torch.parallel.executor import ShardedExecutor

    ex = ShardedExecutor(model, backend="reference", comm=comm)
    B = ex.batch

    def step():
        ex.step(cams[:B], gts[:B], view_indices=list(range(B)),
                backgrounds=[np.zeros(3, np.float32)] * B)

    step()
    comm.bytes.clear()
    bucket = ex._bucket
    step()
    return {"bytes": dict(comm.bytes), "capacity": model.capacity,
            "batch": B, "bucket": bucket, "columns": sum(ex.dims)}


def _step_ranks(rank, world, device, state, gts, k_c):
    """(a) 4 cameras a step at 4 ranks; (c) one real camera a step; (d)
    the wire bytes of one executor step."""
    from log_tpu_torch.parallel.comm import Comm

    comm = Comm()
    cams = _cameras()
    out = {"a": _run_port(_port_model(state), cams, gts, STEPS_A, K_A, 1,
                          world, comm),
           "c": _run_port(_port_model(state), cams, gts, STEPS_C, k_c, 1, 1,
                          comm),
           "d": _wire_step(_port_model(state), cams, gts, Comm()),
           "jax": "jax" in sys.modules, "rank": comm.rank}
    return out if rank == 0 else {"jax": out["jax"], "rank": comm.rank,
                                  "d": out["d"]}


def _jax_toy_model(tmp_path, seed, n=300):
    """tests/test_parallel.py's _toy_tree_model: a 2-level tree built by
    log_tpu's densify, anisotropic scales."""
    from log_tpu.dataset.synthetic import random_gaussians
    from log_tpu.model.level_of_gaussian import LoG

    rng = np.random.default_rng(seed)
    scene = random_gaussians(n, rng)
    npz = tmp_path / "sparse.npz"
    np.savez(npz, xyz=scene["xyz"],
             rgb=(scene["colors"] * 255).astype(np.uint8))
    model = LoG(gaussian={"init_ply": {"filename": str(npz),
                                       "init_opacity": 0.3},
                          "sh_degree": 1, "xyz_scale": 1.0},
                **MODEL_ARGS)
    arrays = {k: np.array(v) for k, v in model.gaussian.to_numpy().items()}
    arrays["scaling"] = (arrays["scaling"] + rng.uniform(
        -0.5, 0.5, arrays["scaling"].shape)).astype(np.float32)
    model.gaussian.set_numpy(arrays)
    model.training_setup()
    model.upgrade_tree()
    n0 = model.num_points
    cnt = {k: np.array(v) for k, v in model.counter.to_numpy(n0).items()}
    cnt["create_steps"][:] = 1000
    cnt["grad_sum"][:16] = 100.0
    cnt["area_sum"][:] = 1
    cnt["radii_max_max"][:16] = 10_000
    model.counter.set_numpy(cnt, model.capacity)
    model.current_depth = 20
    model.update_depth_stage(0)
    assert model.tree.num_nodes > 0
    return model


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """One model (log_tpu's), the GT of 6 views, the port's single-device
    run of (c), and the 4-rank runs of (a) and (c)."""
    tmp = tmp_path_factory.mktemp("parallel")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jmodel = _jax_toy_model(tmp, seed=3)
        state = {k: np.array(v) for k, v in jmodel.state_dict().items()}
        ds = SyntheticDataset(n_gaussians=80, n_views=6, H=H, W=W, seed=7,
                              device="cpu")
        gts = [im.transpose(2, 0, 1).astype(np.float32) for im in ds.images]
        cams = _cameras()
        single = _port_model(state)
        k_seen = set()
        for s in range(STEPS_C):
            i = s % len(cams)
            single.clear()
            vf = single.prepare_from_camera(cams[i])
            k_seen.add((vf["k_leaf"], vf["k_node"]))
            single.train_step(cams[i], gts[i], np.zeros(3, np.float32),
                              view_index=0)
        assert len(k_seen) == 1, f"the bucket must be stable: {k_seen}"
        ranks = spawn(_step_ranks, 4, "cpu",
                      args=(state, gts, next(iter(k_seen))),
                      timeout_s=TIMEOUT_S)
    finally:
        torch.set_num_threads(threads)
    return {"jmodel": jmodel, "state": state, "gts": gts, "cams": cams,
            "single": single, "ranks": ranks}


def _assert_state(want, got, n, rtol, atol, rot=(1e-3, 2e-4), moments=None,
                  counters=True):
    for key, a in want["params"].items():
        a, b = np.asarray(a)[:n], np.asarray(got["params"][key])[:n]
        if key == "rotation":
            a = a / np.linalg.norm(a, axis=-1, keepdims=True)
            b = b / np.linalg.norm(b, axis=-1, keepdims=True)
            np.testing.assert_allclose(a, b, rtol=rot[0], atol=rot[1],
                                       err_msg=f"params[{key}]")
            continue
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=f"params[{key}]")
    if moments is not None:
        for mk in ("exp_avg", "exp_avg_sq"):
            for key, a in want["moments"][mk].items():
                if key == "rotation":
                    continue  # null-direction noise (see above)
                np.testing.assert_allclose(
                    np.asarray(a)[:n], np.asarray(got["moments"][mk][key])[:n],
                    rtol=moments[0], atol=moments[1],
                    err_msg=f"moments[{mk}][{key}]")
    if counters:
        for key in COUNT_EXACT:
            np.testing.assert_array_equal(
                np.asarray(want["counter"][key])[:n],
                np.asarray(got["counter"][key])[:n], err_msg=key)
        for key in COUNT_CLOSE:
            np.testing.assert_allclose(
                np.asarray(want["counter"][key])[:n],
                np.asarray(got["counter"][key])[:n], rtol=2e-3, atol=1e-5,
                err_msg=key)


def test_ranks_import_no_jax(steps):
    assert [r["rank"] for r in steps["ranks"]] == [0, 1, 2, 3]
    assert not any(r["jax"] for r in steps["ranks"])


def test_sharded_step_matches_jax_at_4_ranks(steps):
    """(a) log_tpu's sharded_train_step on 4 virtual devices, the same
    model, cameras, GT and bucket."""
    import jax
    import jax.numpy as jnp

    from log_tpu.model.level_of_gaussian import _host_lrs
    from log_tpu.parallel.sharded_step import (
        ShardedStepConfig as CfgJax, sharded_train_step as step_jax)

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    model, gts, cams = steps["jmodel"], steps["gts"], steps["cams"]
    from log_tpu_torch.parallel.executor import stack_cameras

    params = {k: jnp.array(np.asarray(v))
              for k, v in model.gaussian.params().items()}
    moments = jax.tree.map(lambda v: jnp.array(np.asarray(v)),
                           model.optimizer.moments)
    counter = {k: jnp.array(np.asarray(v))
               for k, v in model.counter.data.items()}
    cap = model.capacity
    leaf = (model.tree.node_index == -1) & (model.tree.depth > 0)
    pad = np.zeros((cap,), bool)
    pad[: leaf.shape[0]] = leaf
    cfg = CfgJax(image_height=H, image_width=W, k_leaf=K_A[0],
                 k_node=K_A[1], sh_degree=model.gaussian.active_sh_degree,
                 n_devices=4, cams_per_device=1, backend="reference",
                 prep_backend="reference", stage_has_tree=True,
                 num_levels=int(model.tree.depth.max()) + 1,
                 max_pairs=1 << 16, prep_max_pairs=1 << 16)
    corr = {"values": jnp.ones((1, 3)), "m1": jnp.zeros((1, 3)),
            "m2": jnp.zeros((1, 3)), "vmax": jnp.zeros((1, 3)),
            "steps": jnp.zeros((1,), jnp.int32)}
    losses = []
    for s in range(STEPS_A):
        sel = [(s * 4 + j) % len(cams) for j in range(4)]
        mats, scalars, centers = stack_cameras([cams[i] for i in sel])
        params, moments, counter, corr, metrics, _ = step_jax(
            params, moments, counter, model.tree.device_arrays(cap),
            jnp.asarray(pad), model.num_points, model.current_depth,
            jnp.full((4,), float(model.tree.min_resolution_pixel),
                     jnp.float32),
            jnp.asarray(mats), jnp.asarray(scalars, jnp.float32),
            jnp.asarray(centers), jnp.zeros((4, 3), jnp.float32),
            jnp.asarray(np.stack([gts[i] for i in sel])),
            jnp.ones((4,), jnp.float32), _host_lrs(model.optimizer, s + 1),
            s + 1, corr, jnp.zeros((4,), jnp.int32), cfg)
        losses.append(float(metrics["loss"]))
    want = {"params": params, "moments": moments, "counter": counter}
    got = steps["ranks"][0]["a"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    _assert_state(want, got, model.num_points, rtol=2e-4, atol=2e-5,
                  moments=(2e-3, 1e-7))


def test_one_rank_four_cameras_equals_four_ranks(steps):
    """(b) the same batches at 1 rank x 4 cameras, in this process."""
    from log_tpu_torch.parallel.comm import Comm

    one = _run_port(_port_model(steps["state"]), steps["cams"], steps["gts"],
                    STEPS_A, K_A, 4, 4, Comm())
    four = steps["ranks"][0]["a"]
    np.testing.assert_allclose(one["losses"], four["losses"], rtol=1e-5)
    n = steps["single"].num_points
    _assert_state(one, four, n, rtol=1e-4, atol=1e-6, counters=False)
    for key in ("visible_count", "area_sum"):
        np.testing.assert_array_equal(one["counter"][key][:n],
                                      four["counter"][key][:n], err_msg=key)


def test_sharded_step_matches_single_device(steps):
    """(c) one camera padded to 4 ranks over 5 steps against the port's
    prepare_from_camera + LoG.train_step."""
    single = steps["single"]
    n = single.num_points
    want = {
        "params": {k: single.gaussian.get(k).numpy()
                   for k in single.gaussian.keys},
        "moments": {mk: {k: v.numpy() for k, v in d.items()}
                    for mk, d in single.optimizer.moments.items()},
        "counter": {k: v.numpy() for k, v in single.counter.data.items()},
    }
    _assert_state(want, steps["ranks"][0]["c"], n, rtol=2e-4, atol=2e-5,
                  moments=(2e-3, 1e-7))


def wire_bytes(capacity, n, batch, k_leaf, k_node, columns):
    """The bytes one rank hands to each collective in one sharded step of
    the tree stage with the check cull and no per-view gain (parallel/
    sharded_step.shard_step and ShardedExecutor.step), B = batch cameras,
    Bl = B / n of them this rank's, K = k_leaf + k_node slice rows, D packed
    f32 columns, cap / n local rows:
      all_gather   Bl (128 + 32)        camera matrices f32, scalars f64
                 + 44 cap / n           the check cull's xyz, scale,
                                        rotation, opacity (11 f32)
                 + 8 Bl K               the slice indices (int64)
                 + 24 Bl K              the counter stats: indices int64,
                                        radii and pixel counts int32,
                                        weights and gradient norms f32
                 + 16 Bl                the kept counts (int64 pairs)
      all_to_all   5 B cap / n          frustum flags (bool) and radii f32
      psum         12                   loss, L1 and SSIM (f32 scalars)
      psum_scatter 4 B K D              every camera's slice rows
      psum_scatter_grad 4 Bl K D        the cotangent of this rank's slices
    """
    bl, k, capl = batch // n, k_leaf + k_node, capacity // n
    return {"all_gather": 160 * bl + 44 * capl + 32 * bl * k + 16 * bl,
            "all_to_all": 5 * batch * capl, "psum": 12,
            "psum_scatter": 4 * batch * k * columns,
            "psum_scatter_grad": 4 * bl * k * columns}


def test_wire_bytes_match_the_formula(steps):
    """(d) every rank hands each collective wire_bytes(...) bytes."""
    for r in steps["ranks"]:
        d = r["d"]
        assert d["bytes"] == wire_bytes(d["capacity"], 4, d["batch"],
                                        *d["bucket"], d["columns"]), r["rank"]
    d = steps["ranks"][0]["d"]
    assert d["batch"] == 4 and d["bucket"][1] > 0 and d["columns"] == 23


# ------------------------------------------------ (e) and (g): two ranks
def _fingerprint(model):
    from log_tpu_torch.parallel.executor import _checksum

    sd = model.state_dict()
    return {k: _checksum(np.asarray(v)) for k, v in sd.items()}


def _executor_ranks(rank, world, device, gts, scene, exp):
    """(e) the executor's round trip, densify and agreement check; then (g)
    the CLI with train.parallel.enable on."""
    from log_tpu_torch.apps import train
    from log_tpu_torch.parallel.executor import ShardedExecutor, toy_tree_model

    from log_tpu_torch.parallel.comm import Comm

    out = {"pid": os.getpid(),
           "broadcast": Comm().broadcast(torch.tensor([rank + 1.0])).item()}
    model = toy_tree_model(300, seed=5, device=device)
    before = {k: np.array(v) for k, v in model.state_dict().items()}
    ex = ShardedExecutor(model, cams_per_device=1, backend="reference")
    ex.sync_to_model()
    after = model.state_dict()
    out["round_trip"] = sorted(k for k in before
                               if not np.array_equal(before[k], after[k]))
    cams = _cameras()
    for s in range(2):
        ex.step([cams[(2 * s + j) % 6] for j in range(2)],
                [gts[(2 * s + j) % 6] for j in range(2)],
                view_indices=[0, 0], backgrounds=[np.zeros(3)] * 2)
    ex.sync_to_model()
    n = model.num_points
    cnt = {k: np.array(v) for k, v in model.counter.to_numpy(n).items()}
    leaves = np.flatnonzero((model.tree.node_index == -1)
                            & (model.tree.depth > 0))[:8]
    cnt["create_steps"][:] = 1000
    cnt["grad_sum"][leaves] = 100.0
    cnt["area_sum"][:] = 1
    cnt["radii_max_max"][leaves] = 10_000
    model.counter.set_numpy(cnt, model.capacity)
    model.update_depth_stage(0)
    out["densify"] = (n, model.num_points)
    ex.refresh_from_model()
    metrics, _ = ex.step([cams[0], cams[1]], [gts[0], gts[1]])
    out["loss"] = float(metrics["loss"])
    ex.sync_to_model()
    out["model"] = _fingerprint(model)
    # a rank whose model differs: every rank's refresh raises
    if rank == 1:
        model.gaussian.set("xyz", model.gaussian.get("xyz") + 1e-3)
    try:
        ex.refresh_from_model()
        out["mismatch"] = None
    except RuntimeError as e:
        out["mismatch"] = str(e)

    os.chdir(REPO)
    trainer = train.main(
        ["--cfg", "config/synthetic_parallel/train.yml", "--device", "cpu",
         "split", "train"] + _cli_opts(scene, exp)
        + ["train.parallel.enable", "on"])
    out["cli"] = {"executor": trainer.executor is not None,
                  "batch": trainer.executor.batch,
                  "model": _fingerprint(trainer.model),
                  "num_points": trainer.model.num_points,
                  "steps": trainer.model.optimizer.global_steps}
    return out


def _cli_opts(scene, exp):
    return ["root", scene, "PLYNAME", f"{scene}/sparse/0/sparse.npz",
            "exp", exp, "dataset.args.ext", ".png",
            "val_dataset.args.ext", ".png", "base_iter", "4",
            "log_interval", "4", "val.iteration", "8",
            "NAIVE_STAGE.init.loader.args.iterations", "2",
            "NAIVE_STAGE.tree.loader.args.iterations", "2",
            "model.args.gaussian.init_ply.init_opacity", "0.5"]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    from log_tpu_torch.apps import make_synthetic_scene

    root = tmp_path_factory.mktemp("two_ranks")
    scene, exp = str(root / "scene"), str(root / "out" / "log")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        make_synthetic_scene.main([scene, "300", "8", "64", "80", ".png",
                                   "--device", "cpu"])
        ds = SyntheticDataset(n_gaussians=80, n_views=6, H=H, W=W, seed=7,
                              device="cpu")
        gts = [im.transpose(2, 0, 1).astype(np.float32) for im in ds.images]
        ranks = spawn(_executor_ranks, 2, "cpu", args=(gts, scene, exp),
                      timeout_s=TIMEOUT_S)
    finally:
        torch.set_num_threads(threads)
    return {"ranks": ranks, "exp": exp}


def test_executor_round_trip_and_densify(two_ranks):
    """(e)"""
    r0, r1 = two_ranks["ranks"]
    assert r0["broadcast"] == r1["broadcast"] == 1.0  # rank 0's value
    assert r0["round_trip"] == [] and r1["round_trip"] == []
    n_before, n_after = r0["densify"]
    assert n_after > n_before and r1["densify"] == r0["densify"]
    assert np.isfinite(r0["loss"]) and r0["loss"] == r1["loss"]
    assert r0["model"] == r1["model"]
    for r in (r0, r1):
        assert r["mismatch"] is not None and "gaussian.xyz" in r["mismatch"]


def test_trainer_parallel_two_ranks(two_ranks):
    """(g) both ranks train the same model; only rank 0 writes."""
    r0, r1 = two_ranks["ranks"]
    exp = two_ranks["exp"]
    assert r0["cli"]["executor"] and r0["cli"]["batch"] == 2
    assert r0["cli"]["model"] == r1["cli"]["model"]
    # 2 stages x 2 x base_iter 4 sharded steps of 2 cameras
    assert r0["cli"]["steps"] == r1["cli"]["steps"] == 16
    for stage in ("init", "tree"):
        assert os.path.exists(os.path.join(exp, f"model_{stage}.pth"))
    with open(os.path.join(exp, ".lock")) as f:
        assert int(f.read().strip()) == r0["pid"]
    backups = [d for d in os.listdir(exp) if d.startswith("code_backup_")]
    assert len(backups) == 1
    with open(os.path.join(exp, backups[0], "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    keys = [(r["step"], r["key"]) for r in rows]
    assert rows and len(keys) == len(set(keys))  # one writer


# ------------------------------------------------------------ (f) the mesh
def test_make_mesh_matches_jax():
    from log_tpu.parallel import mesh as mesh_jax

    for n in range(1, 9):
        try:
            want = mesh_jax.make_mesh(n).devices.shape
        except AssertionError:
            with pytest.raises(ValueError):
                mesh.make_mesh(n)
            continue
        got = mesh.make_mesh(n)
        assert got.grid.shape == want, n
        assert got.grid.ravel().tolist() == list(range(n))
        assert got.groups == {}


def test_initialize_distributed_is_a_no_op_without_its_variables(
        monkeypatch):
    for name in ("LOG_TPU_COORDINATOR", "LOG_TPU_NUM_PROCESSES",
                 "LOG_TPU_PROCESS_ID", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                 "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert mesh.initialize_distributed(device="cpu") is None
    assert not torch.distributed.is_initialized()
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(mesh.shard_rows(torch.arange(8), 1, 4),
                       torch.tensor([2, 3]))
    with pytest.raises(ValueError):
        mesh.shard_rows(x, 0, 2)
