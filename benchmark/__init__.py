"""The benchmark of log_tpu_torch, the PyTorch and CUDA port: the harness
(`harness/`), the plain reference (`reference/`), the cells' data
(`configs/`, `traffic/`, `limits/`) and one reader per per-layer metric
(`metrics/`). Run it as `python benchmark/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`."""
