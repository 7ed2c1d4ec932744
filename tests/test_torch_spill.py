"""The port's host-spill tier on the CPU: Adam moments moved to host
memory past the optimizer's thresholds, gathered before each step and
scattered after it (model/sparse_optimizer.py, LoG.train_step). The
port's counterparts of tests/test_spill.py, and the spilled step against
log_tpu's.

Limits: the spilled run equals the device run bit for bit (both run the
same torch Adam ops on the same rows); against log_tpu the limits of
tests/test_torch_train_step.py (loss to 1e-5, first moments to 1e-3 of
each key's largest, parameters to 1e-6 where the gradient is above 1e-4
of its key's largest, integer counters equal, float counters to 1e-4).
"""
import math

import numpy as np
import pytest
import torch

from log_tpu.dataset.synthetic import SyntheticDataset as SyntheticJax
from log_tpu.model.level_of_gaussian import LoG as LoGJax
from log_tpu.utils.file import knn_mean_sq_dist
from log_tpu_torch.model import level_of_gaussian as lg
from log_tpu_torch.model.counter import COUNTER_KEYS
from log_tpu_torch.utils import hbm
from log_tpu_torch.utils.config import load_object

from test_torch_train_step import (KEYS, _train_models, _views,
                                   assert_counters_close,
                                   assert_moments_close, assert_params_close)
from test_train_smoke import MODEL_CFG

KINDS = ("exp_avg", "exp_avg_sq")


@pytest.fixture(autouse=True)
def _pin_env(monkeypatch):
    monkeypatch.setenv("LOG_TPU_PACK_SORT_KEYS", "0")
    monkeypatch.delenv("LOG_TPU_BACKEND", raising=False)
    monkeypatch.delenv("LOG_TPU_COMPACT", raising=False)
    monkeypatch.delenv("LOG_TPU_IDENTITY_STEP", raising=False)


@pytest.fixture(scope="module")
def dataset():
    return SyntheticJax(n_gaussians=120, n_views=6, H=48, W=64, seed=0)


def build_model(dataset, package="port"):
    """tests/test_train_smoke.py's model in either package, from the
    dataset's noisy point cloud with the JAX package's KNN scales."""
    pc = dataset.noisy_pointcloud()
    scales = np.sqrt(np.maximum(knn_mean_sq_dist(pc["xyz"]), 1e-7))
    if package == "port":
        model = load_object("LoG.model.level_of_gaussian.LoG", MODEL_CFG,
                            device="cpu")
    else:
        model = LoGJax(**MODEL_CFG)
    model.gaussian.register_by_pointcloud(pc["xyz"], pc["colors"], scales,
                                          init_opacity=0.5)
    model.counter.reset(model.num_points, model.capacity)
    model.counter.set_numpy(
        {"radius3d_min": np.full(model.num_points, 1e-4, np.float32),
         "radius3d_max": np.full(model.num_points, 1.0, np.float32)},
        model.capacity)
    model.base_iter = 10
    model.training_setup()
    return model


def run_steps(model, dataset, n_steps=6, use_iteration=False):
    bg = dataset.background
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n_steps):
        item = dataset[int(rng.integers(len(dataset)))]
        gt = item["image"].transpose(2, 0, 1)
        if use_iteration:
            out.append(model.training_iteration(item["camera"], gt, bg,
                                                view_index=item["index"]))
        else:
            model.prepare_from_camera(item["camera"])
            out.append(model.train_step(item["camera"], gt, bg,
                                        view_index=item["index"]))
    return out


def _state(model):
    """params, moments and counters of the live rows, as numpy."""
    sd = model.state_dict()
    return {k: np.array(v) for k, v in sd.items()
            if k.split(".")[0] in ("gaussian", "optimizer", "counter")}


def test_spill_matches_device_path(dataset, monkeypatch):
    """Both moment kinds spilled: the same parameters, moments and counters
    as the device path, bit for bit (the sparse step on both sides: a
    spilled step never takes the identity fast path)."""
    monkeypatch.setenv("LOG_TPU_IDENTITY_STEP", "0")
    ref = build_model(dataset)
    run_steps(ref, dataset)
    spill = build_model(dataset)
    spill.optimizer.to_host(("exp_avg_sq", "exp_avg"))
    assert spill.optimizer.spilled == KINDS
    assert spill.optimizer.moments == {"exp_avg": {}, "exp_avg_sq": {}}
    run_steps(spill, dataset)
    want, got = _state(ref), _state(spill)
    assert set(got) == set(want)
    for key, val in want.items():
        assert np.array_equal(got[key], val), key
    # the host moments hold the updates (capacity rows, padding zero)
    n, cap = spill.num_points, spill.capacity
    for mk in KINDS:
        host = spill.optimizer.host_moments[mk]
        assert host["xyz"][:n].abs().sum() > 0
        for k, v in host.items():
            assert v.shape[0] == cap and v.device.type == "cpu"
            assert not v[n:].any(), (mk, k)
    moved = spill.optimizer.transfer_bytes
    assert moved["h2d"] == moved["d2h"] > 0


def test_spill_training_iteration_path(dataset):
    """training_iteration falls back to the two-phase step while spilled
    and keeps optimizing."""
    model = build_model(dataset)
    model.optimizer.to_host(("exp_avg_sq",))
    (metrics, _), = run_steps(model, dataset, n_steps=1, use_iteration=True)
    assert math.isfinite(float(metrics["loss"]))
    assert model.optimizer.moments["exp_avg_sq"] == {}
    assert model.optimizer.moments["exp_avg"]  # still on the device
    assert model._bucket is None  # the fused path never ran
    assert any(v.abs().sum() > 0 for v in
               model.optimizer.host_moments["exp_avg_sq"].values())


def test_auto_spill_threshold(dataset):
    """exp_avg_sq past spill_points, exp_avg too past spill_points_full,
    each once; the thresholds come from lr_dict where it names them."""
    model = build_model(dataset)
    opt = model.optimizer
    assert (opt.spill_points, opt.spill_points_full) == (50_000_000,
                                                         100_000_000)
    n = model.num_points
    assert not opt.maybe_spill(n)
    opt.spill_points = n - 1
    assert opt.maybe_spill(n)
    assert opt.spilled == ("exp_avg_sq",)
    assert not opt.maybe_spill(n)  # a second call is a no-op
    opt.spill_points_full = n - 1
    assert opt.maybe_spill(n)
    assert opt.spilled == KINDS
    assert not opt.maybe_spill(n)
    cfg = dict(MODEL_CFG, optimizer=dict(
        MODEL_CFG["optimizer"], lr_dict=dict(MODEL_CFG["optimizer"]["lr_dict"],
                                             spill_points=7,
                                             spill_points_full=9)))
    model = load_object("LoG.model.level_of_gaussian.LoG", cfg, device="cpu")
    model.training_setup()
    assert (model.optimizer.spill_points,
            model.optimizer.spill_points_full) == (7, 9)


def test_spill_survives_host_densify(dataset):
    """The host densify routes spilled moments through numpy (to_numpy and
    set_numpy are spill-aware) and training continues."""
    model = build_model(dataset)
    run_steps(model, dataset, n_steps=8)
    model.optimizer.to_host(("exp_avg_sq",))
    assert not model._use_device_densify()
    model.update_init_stage()
    assert model.optimizer.spilled == ("exp_avg_sq",)
    for v in model.optimizer.host_moments["exp_avg_sq"].values():
        assert v.shape[0] == model.capacity
    for v in model.optimizer.moments["exp_avg"].values():
        assert v.shape[0] == model.capacity
    (metrics, _), _ = run_steps(model, dataset, n_steps=2)
    assert math.isfinite(float(metrics["loss"]))


def test_spilled_step_matches_jax(dataset, monkeypatch):
    """One spilled step (both kinds) in both packages from the same point
    cloud, on the oracle."""
    monkeypatch.setenv("LOG_TPU_BACKEND", "reference")
    port, ref = build_model(dataset), build_model(dataset, "jax")
    for m in (port, ref):
        m.optimizer.to_host(("exp_avg_sq", "exp_avg"))
    out_p = run_steps(port, dataset, n_steps=1)
    out_j = run_steps(ref, dataset, n_steps=1)
    for (met_p, _), (met_j, _) in zip(out_p, out_j):
        assert abs(float(met_p["loss"]) - float(met_j["loss"])) <= 1e-5
    n = port.num_points
    sd_p, sd_j = port.state_dict(), ref.state_dict()
    assert set(sd_p) == set(sd_j)
    m_p = {mk: {k: sd_p[f"optimizer.{mk}.{k}"] for k in KEYS} for mk in KINDS}
    m_j = {mk: {k: sd_j[f"optimizer.{mk}.{k}"] for k in KEYS} for mk in KINDS}
    assert_moments_close(m_p, m_j, n)
    # isotropic initial scales: the rotation gets no gradient in either
    moved = [k for k in KEYS if np.abs(m_j["exp_avg"][k]).max() > 0]
    assert "rotation" not in moved and "xyz" in moved
    for k in set(KEYS) - set(moved):
        assert not np.abs(m_p["exp_avg"][k]).any(), k
        np.testing.assert_array_equal(sd_p[f"gaussian.{k}"],
                                      sd_j[f"gaussian.{k}"], err_msg=k)
    assert_params_close({k: sd_p[f"gaussian.{k}"] for k in moved},
                        {k: sd_j[f"gaussian.{k}"] for k in moved}, m_j, n)
    assert_counters_close({k: sd_p[f"counter.{k}"] for k in COUNTER_KEYS},
                          {k: sd_j[f"counter.{k}"] for k in COUNTER_KEYS}, n)


def test_spilled_state_dict_loads_in_jax(dataset):
    """A spilled model's checkpoint carries its host moments under the
    reference's keys; log_tpu loads it and hands back the same arrays, and
    the port loads it back into a spilled optimizer."""
    port = build_model(dataset)
    port.optimizer.to_host(("exp_avg_sq",))
    run_steps(port, dataset, n_steps=3)
    sd = port.state_dict()
    before = {k: np.array(v) for k, v in sd.items()}
    run_steps(port, dataset, n_steps=1)  # snapshots are copies
    assert all(np.array_equal(sd[k], v) for k, v in before.items())
    assert np.abs(sd["optimizer.exp_avg_sq.xyz"]).sum() > 0
    ref = LoGJax(**MODEL_CFG)
    ref.load_state_dict(sd, split="train")
    back = ref.state_dict()
    for key, val in sd.items():
        np.testing.assert_array_equal(np.asarray(back[key]), val, err_msg=key)
    again = build_model(dataset)
    again.optimizer.to_host(("exp_avg_sq",))
    again.load_state_dict(sd, split="train")
    assert again.optimizer.spilled == ("exp_avg_sq",)
    for key, val in again.state_dict().items():
        np.testing.assert_array_equal(val, sd[key], err_msg=key)


def test_host_index_equals_step_index(monkeypatch):
    """The rows the host gathers are the step's compacted lanes, lane for
    lane, leaf and node buckets both (a three-level tree)."""
    port, _ = _train_models()
    port.optimizer.to_host(KINDS)
    seen = []
    gather = port.optimizer.host_gather

    def record(index):
        seen.append(np.array(index))
        return gather(index)

    monkeypatch.setattr(port.optimizer, "host_gather", record)
    for pc, gt, bg, vi in _views()[:2]:
        _, aux = port.training_iteration(pc, gt, bg, view_index=vi)
        vf = port.visibility_flag
        assert vf["k_node"] > 0 and vf["k_leaf"] + vf["k_node"] < port.capacity
        assert np.array_equal(seen[-1], aux["index"].numpy())
        assert (seen[-1] < port.capacity).sum() == sum(vf["counts"])


def test_hbm_raises_off_the_card():
    """Device memory telemetry on a CPU device is an error, not zeros."""
    for fn in (hbm.live_bytes, hbm.device_limit, hbm.hbm_usage):
        with pytest.raises(ValueError, match="CUDA device"):
            fn("cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        hbm.call_stats(lambda: 1, device=torch.device("cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            hbm.hbm_usage()


def test_step_needs_the_spilled_rows():
    with pytest.raises(ValueError, match="m_slices"):
        lg.fused_train_step(
            {"xyz": torch.zeros(4, 3)}, {}, {}, None, None, None, None, None,
            {}, 1.0, {}, 0, None, None,
            lg.StepConfig(image_height=8, image_width=8, k_leaf=4, k_node=0,
                          sh_degree=0, spilled=("exp_avg",)))
