"""A whole training run of the port's CLI held against the JAX package's
CLI, step by step, on the host densify path (tests/lockstep_runs.py).

config/synthetic/train.yml with tests/test_torch_trainer.py's overrides
(300 Gaussians, 8 views at 64x80, base_iter 8, 3 + 3 loader iterations:
48 steps, one init densify and one tree upgrade) on
LOG_TPU_BACKEND=reference in both packages. The two runs start from the
same files and seed and draw the same random numbers: the model's densify
stream takes the first global numpy draw after seed_everything(666) and
the dataset's crop stream the second, in both CLIs. Before that was so
(the port's model seeded its stream with 0), the first init densify kept
64 points in the port against the JAX package's 88, and every later step
differed.

Limits (lockstep_runs.py): the views, backgrounds and float32 LRs equal at
every step, the loss within 1e-4 relative, the point count, capacity and
tree depth equal after every densify and upgrade, every validation record
within 0.02 dB PSNR and 1e-3 SSIM, the final parameters within the stated
limits. No densify flipped: nothing is carried across.
"""
import lockstep_runs as L


def test_cli_lockstep_host_densify(tmp_path):
    runs = L.run_both(tmp_path)
    gaps = L.compare(runs)
    assert len(runs["port"]["events"]) == 2  # the init densify, the upgrade
    print(gaps)
