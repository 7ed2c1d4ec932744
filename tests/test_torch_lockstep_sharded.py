"""A whole run of the port's sharded CLI (cfg.train.parallel) held against
the JAX package's CLI, step by step, at two ranks
(tests/lockstep_runs.py's run_both_sharded).

config/synthetic_parallel/train.yml with train.parallel.n_devices 2 in
both packages: the JAX CLI in this process on two of the conftest's
virtual CPU devices, the port's CLI at two gloo ranks
(parallel/launch.spawn, one torch thread each), both on
LOG_TPU_BACKEND=reference, on the lockstep scene (300 Gaussians, 8 views
at 64x80). Overrides: base_iter 4, validation every 8, init opacity 0.5,
3 + 3 loader iterations (24 sharded steps of 2 cameras; the schedule never
updates after a stage's last batch, so 2 + 2 would reach only the counter
reset), and RGB_RENDER_L1_SSIM.args.use_rand_radius True, so that every
camera draws its LoD jitter after its background and the order of the two
draws is held as well. The run holds the init densify at global iteration
7 (300 -> 90 points, each rank's block 192 -> 128 rows), the upgrade at 19,
validations at 1, 7, 13 and 19, and the per-view gain from step 4
(base_iter; its table has 8 rows, so fact ah's rule applies it in both
packages).

Limits: run_both's, none looser. The views, backgrounds, LoD min_res,
float32 LRs and slice buckets equal at every step; the loss within 1e-4
relative; the densifies, upgrades and re-shards (point count, capacity,
depth, each rank's rows) equal; every validation within 0.02 dB and 1e-3
SSIM; the final parameters within PARAM_ATOL / PARAM_SHARE / PARAM_MAX and
the trees equal; rank 1's final model equal to rank 0's bit for bit.
Measured on the CPU: loss 3.5e-6 relative (the single-device lockstep:
4.2e-6), validation 2.4e-6 dB and 7.4e-6 SSIM, final rotation 3.0e-3 and
every other parameter within 9e-6. Fact ah (the JAX executor's camera
scalars in f32, the port's in float64) fits inside those limits. No
densify flipped: nothing is carried across.
"""
import numpy as np

import lockstep_runs as L


def test_cli_lockstep_sharded_two_ranks(tmp_path):
    runs = L.run_both_sharded(
        tmp_path, ["RGB_RENDER_L1_SSIM.args.use_rand_radius", "True"])
    gaps = L.compare_sharded(runs)
    port, jax_run = runs["port"], runs["jax"]
    # two stages of base_iter x loader iterations sharded steps
    assert len(port["steps"]) == 2 * L.SHARDED_BASE_ITER * \
        L.SHARDED_ITERATIONS
    assert all(len(s["views"]) == L.RANKS for s in port["steps"])
    # the jitter is drawn: not every camera at the tree's own threshold
    assert len({m for s in port["steps"] for m in s["min_res"]}) > 1
    # the init densify and the upgrade, each re-sharded over both ranks
    assert [e[0] for e in port["events"]] == [7, 19]
    assert port["reshards"][-1][2] == [port["reshards"][-1][1] // L.RANKS] * 2
    assert [v["iteration"] for v in port["vals"]] == [1, 7, 13, 19]
    # the per-view gain trained in both packages, to the same values
    key = "view_correction.view_correction"
    g, w = np.asarray(port["final"][key]), np.asarray(jax_run["final"][key])
    assert np.abs(w - 1).max() > 0.1
    np.testing.assert_allclose(g, w, rtol=0, atol=L.PARAM_ATOL)
    print(gaps)
