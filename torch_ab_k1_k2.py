#!/usr/bin/env python3
"""A/B of the port's K1 and K2 (log_tpu_torch/csrc/rasterize_fwd.cu and
rasterize_bwd.cu) against another version of the same two sources, on one
CUDA card.

    python3 torch_ab_k1_k2.py --old DIR [--out FILE]

DIR holds the other version's rasterize_fwd.cu and rasterize_bwd.cu (and
any header they include), for example a past commit's, written with
`git show <commit>:log_tpu_torch/csrc/rasterize_fwd.cu` into a git-ignored
directory such as build/ab_old. Both versions are compiled with the port's
nvcc flags into libraries of their own with the same C interface
(log_rasterize_fwd / log_rasterize_bwd); the port's wrappers
(rasterize_forward, rasterize_backward) run with each library in turn.

Inputs:
- the main path's own recorded calls, those of chip_smoke.py: generic
  frame 0 of the 1920x1088 orbit on the 3.24M-point synthetic tree (K1's
  cull render "weights" and frame render False) and training step 0 of the
  training phase (K1 "weights" and True, K2). Timed in turns (old, new,
  new, old; CUDA events, mean of 10 launches after one warm-up);
- the adversarial 2 x 2-tile records of tests/test_torch_footprint.py
  (thin, near-degenerate, faint, tile-wide and NaN splats, boxes ending on
  patch borders, a run saturating mid-chunk), seeds ADVERSARIAL_SEEDS, in
  all three K1 modes and through K2. Not timed.
On every input the new K1 must equal the old one bit for bit in all six
outputs, and the new K2 must agree with the old within 1e-5 of its largest
gradient (with the same non-finite entries) and repeat itself bit for bit.
Prints the card, the ptxas report of each version and one JSON line, also
written to --out.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

REPS = 10
K2_REL_TOL = 1e-5
ADVERSARIAL_SEEDS = tuple(range(3, 11))
MODES = (False, "weights", True)


def build_versions(src_dirs, out_dir):
    """{name: ctypes.CDLL} for {name: source dir}: one nvcc per version,
    all started together."""
    from log_tpu_torch.ops import kernels

    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = kernels._nvcc()
    procs = {}
    for name, d in src_dirs.items():
        lib = out_dir / f"libab_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", str(lib),
             str(d / "rasterize_fwd.cu"), str(d / "rasterize_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        log = p.communicate()[0]
        print(f"--- {name}: {src_dirs[name]}")
        for line in log.splitlines():
            if "Used" in line or "error" in line or "spill" in line:
                print("  ptxas: " + line.strip())
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        for fn in ("log_rasterize_fwd", "log_rasterize_bwd"):
            getattr(cdll, fn).argtypes = kernels._SIGNATURES[fn]
            getattr(cdll, fn).restype = ctypes.c_int
        libs[name] = cdll
    return libs


@contextlib.contextmanager
def kernel_library(lib):
    """The port's wrappers launch from lib while inside."""
    from log_tpu_torch.ops import kernels

    saved = kernels._lib
    kernels._lib = lib
    try:
        yield
    finally:
        kernels._lib = saved


def run_fwd(lib, a, mode):
    from log_tpu_torch.ops import rasterize_tiled as rt

    with kernel_library(lib):
        return rt.rasterize_forward(*a, mode)


def run_bwd(lib, args):
    from log_tpu_torch.ops import rasterize_tiled as rt

    with kernel_library(lib):
        return rt.rasterize_backward(*args)


def record_inputs(device, log):
    """K1's calls of generic frame 0 and of training step 0, and K2's."""
    import torch

    from log_tpu_torch.render.renderer import NaiveRendererAndLoss
    from log_tpu_torch.utils.trainer import Trainer

    model = cs.build_model(cs.N_ROOTS, device)
    renderer = NaiveRendererAndLoss(split="demo", device=device)
    frame = cs.record_kernel_inputs(model, renderer, cs.orbit_batches(1)[0])
    del model, renderer
    torch.cuda.empty_cache()
    model = cs.build_train_model(device)
    batches = cs.train_batches()
    cs.make_ground_truth(model, batches, device, log)
    renderer = NaiveRendererAndLoss(split="train", use_randback=True,
                                    device=device)
    trainer = Trainer({}, model, renderer, seed=cs.SEED)
    step = {}
    with cs.recording(step):
        trainer.training_step(model, batches[0])
    torch.cuda.synchronize()
    k1 = {}
    for label, calls in (("frame", frame), ("step", step)):
        for args, _ in calls["rasterize_fwd"]:
            k1[(label, args[6])] = args[:6]
    cases = [("generic frame cull", "weights", k1[("frame", "weights")]),
             ("generic frame", False, k1[("frame", False)]),
             ("training step cull", "weights", k1[("step", "weights")]),
             ("training step", True, k1[("step", True)])]
    return cases, step["rasterize_bwd"][0][0]


def adversarial_inputs(seed, device):
    """K1's arguments on the adversarial records of one seed."""
    import torch

    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_footprint import _tile_pairs

    pair, ts, tc, tiles_x, tiles_y = _tile_pairs(seed)
    return (pair.to(device), ts.to(device), tc.to(device),
            torch.tensor([0.1, 0.2, 0.3], device=device), tiles_x, tiles_y)


def same_bits(x, y):
    import torch

    return torch.equal(cs._bits(x), cs._bits(y))


def same_k1(x, y):
    return all(same_bits(u, v) for u, v in zip(x, y))


def k2_rel_err(new, old):
    """max |new - old| over old's largest finite gradient (rows 0-8), or
    inf where the non-finite entries differ."""
    import torch

    fin = torch.isfinite(old)
    if not torch.equal(fin, torch.isfinite(new)):
        return float("inf")
    scale = float(old[:9][fin[:9]].abs().max())
    return float((new[:9] - old[:9])[fin[:9]].abs().max()) / scale


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, type=Path)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "ab_k1_k2.json")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ab_k1_k2: no CUDA device", file=sys.stderr)
        return 2

    def log(msg):
        print(msg, flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    from log_tpu_torch.ops.kernels import CSRC

    t0 = time.perf_counter()
    libs = build_versions({"old": opt.old.resolve(), "new": CSRC},
                          ROOT / "build" / "ab")
    log(f"built {len(libs)} versions in {time.perf_counter() - t0:.1f} s")
    old, new = libs["old"], libs["new"]
    turns = (("old", old), ("new", new), ("new", new), ("old", old))
    result = {"card": smi, "reps": REPS, "k1": [], "k2": {},
              "adversarial": []}
    failures = []
    with torch.no_grad():
        # the adversarial records first: small, untimed
        for seed in ADVERSARIAL_SEEDS:
            a = adversarial_inputs(seed, "cuda")
            row = {"seed": seed, "k1_identical": {}}
            for mode in MODES:
                same = same_k1(run_fwd(new, a, mode), run_fwd(old, a, mode))
                row["k1_identical"][repr(mode)] = same
                if not same:
                    failures.append(f"K1 seed {seed} {mode!r} differs")
            fwd = run_fwd(old, a, True)
            g = torch.Generator(device="cuda").manual_seed(seed)
            dcolor = torch.randn(fwd[0].shape, device="cuda", generator=g)
            dalpha = torch.randn(fwd[1].shape, device="cuda", generator=g)
            bargs = (*a[:3], fwd[5], fwd[1], dcolor, dalpha, *a[3:])
            g_new = run_bwd(new, bargs)
            row["k2_rel_err_to_old"] = k2_rel_err(g_new, run_bwd(old, bargs))
            row["k2_reproducible"] = same_bits(
                g_new, run_bwd(new, bargs))
            if (row["k2_rel_err_to_old"] > K2_REL_TOL
                    or not row["k2_reproducible"]):
                failures.append(f"K2 seed {seed}: {row}")
            log(f"adversarial seed {seed}: {row}")
            result["adversarial"].append(row)

        cases, k2_args = record_inputs("cuda", log)
        for call, mode, a in cases:
            outs = {"old": run_fwd(old, a, mode), "new": run_fwd(new, a, mode)}
            times = {"old": [], "new": []}
            for name, lib in turns:
                times[name].append(cs.device_ms(
                    lambda: run_fwd(lib, a, mode), REPS))
            same = same_k1(outs["new"], outs["old"])
            row = {"call": call, "with_stats": mode,
                   "ms": {n: sum(t) / len(t) for n, t in times.items()},
                   "turns_ms": times, "identical_to_old": same}
            if not same:
                failures.append(f"K1 {call} {mode!r} differs")
            cend = outs["old"][5].float()
            runs = a[2].float()
            row["tiles"] = {"chunks_max": float(cend.max()),
                            "chunks_mean": float(cend.mean()),
                            "chunks_p99": float(torch.quantile(cend, 0.99)),
                            "run_max": float(runs.max()),
                            "run_mean": float(runs.mean())}
            log(f"   tiles: chunks composited {row['tiles']}")
            log(f"K1 {call:20s} with_stats={mode!r:9s} old "
                f"{row['ms']['old']:.4f} ms, new {row['ms']['new']:.4f} ms; "
                f"identical to old {same}")
            result["k1"].append(row)

        grads = {"old": run_bwd(old, k2_args), "new": run_bwd(new, k2_args)}
        times = {"old": [], "new": []}
        for name, lib in turns:
            times[name].append(cs.device_ms(
                lambda: run_bwd(lib, k2_args), REPS))
        rel = k2_rel_err(grads["new"], grads["old"])
        row = {"ms": {n: sum(t) / len(t) for n, t in times.items()},
               "turns_ms": times,
               "max_abs_old": float(grads["old"][:9].abs().max()),
               "rel_err_to_old": rel,
               "reproducible": same_bits(
                   grads["new"], run_bwd(new, k2_args))}
        if rel > K2_REL_TOL or not row["reproducible"]:
            failures.append(f"K2 training step: rel err {rel}, "
                            f"reproducible {row['reproducible']}")
        log(f"K2 training step old {row['ms']['old']:.4f} ms, new "
            f"{row['ms']['new']:.4f} ms; rel err to old {rel:.3g}; "
            f"reproducible {row['reproducible']}")
        result["k2"] = row
    result["failures"] = failures
    opt.out.parent.mkdir(parents=True, exist_ok=True)
    opt.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    for f in failures:
        print("FAIL: " + f, file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
