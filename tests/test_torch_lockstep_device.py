"""The lockstep run of tests/test_torch_lockstep_host.py on the device
densify path (`model.args.densify_and_remove.device_densify on`, as
config/synthetic_conv and config/synthetic_big set it): the init densify's
keep mask is `jax.random.uniform(PRNGKey(k), (2, capacity))` with k drawn
from the model's numpy stream, which the port draws on the model's device
with utils/jax_random.py. Same limits; no densify flipped.
"""
import lockstep_runs as L


def test_cli_lockstep_device_densify(tmp_path):
    runs = L.run_both(
        tmp_path, ["model.args.densify_and_remove.device_densify", "on"])
    gaps = L.compare(runs)
    assert len(runs["port"]["events"]) == 2
    print(gaps)
