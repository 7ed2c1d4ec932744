"""Scale, dissection and probe scripts of the port, counterparts of the
repo's scripts/.

Each module has `run(..., device=None) -> dict` (the card unless the caller
passes device="cpu"; raises where CUDA is absent) and a `main()` that
prints one JSON line, run as `python -m log_tpu_torch.scripts.<name>`:

- `bench_trainstep`: the init-stage training step at 1920x1088, 100k points;
- `bench_spill`: the same geometry through `LoG.training_iteration` on the
  device path and with one or both Adam moment kinds spilled to the host;
- `bench_4k`: 3840x2160 block frames on the 3.24M-point tree, and one 4K
  vanilla frame through `render_one`;
- `bench_capacity`: the 10.26M-point tree at 1080p: memory, block and
  fused frames, the tree-stage step, and the spill thresholds;
- `bench_frame_dissect`: the flat_slice and block frames by stage, and the
  probes (headline, cull, kernel2, prims, blocksize, demand, trace);
- `bench_trainstep_dissect`: the init-stage step's cumulative prefixes;
- `bench_kernel`: K1 (and K5) alone on synthetic sorted pair tables;
- `bench_explore`: prepare, render and fused phases of the generic frame;
- `bench_sortcost`, `bench_gathercost`, `bench_blockgather`: the sort,
  gather and block-take primitives;
- `backend_equivalence`: one config trained on the tiled backend and on
  the oracle;
- `check_sharded_fullscale`: the band exchange at full scale on gloo ranks.

`make_quality_artifacts.sh` takes the val split, the demo and curated
copies of a finished config/synthetic_conv run through the port's CLI.
"""
