"""The plain reference of the benchmark: the LoD cut and root cull, the
projection and SH colours, the tiled compositing, the 0.8 L1 + 0.2 SSIM
loss, its backward (autograd) and sparse Adam, in plain PyTorch.

It imports nothing of the program under test (`log_tpu_torch`) and nothing
of the JAX package; it works from the checkpoint, cameras and images that
the benchmark makes from the seed (benchmark/harness/inputs.py). Every
function takes a `Prec`: float32 for the reference, and one step lower for
the control that the limits are set against (bfloat16 arithmetic, splat
records rounded to float8 where the program packs bfloat16).
"""
