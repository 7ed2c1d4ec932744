#!/usr/bin/env python3
"""A/B of the port's compositing and compaction kernels (log_tpu_torch/csrc)
against another version of the same sources, on one CUDA card.

    python3 torch_ab_k1_k2.py --old DIR [--kernels k1k2,k5,k6] [--out FILE]

DIR holds the other version's csrc/ (every .cu and the headers they
include), for example a past commit's, unpacked with
`git archive <commit> log_tpu_torch/csrc | tar -x --strip-components=2 -C DIR`
into a git-ignored directory such as build/ab_old. Both versions are
compiled with the port's nvcc flags (one nvcc per source, all started
together) into libraries of their own; the port's wrappers run with each
library in turn. K1, K2 and K5 keep one C interface across versions. K6's
C interface gained its `valid` output with the one-launch kernel: a
version whose compact.cu still has the three-launch interface is called
the way its own wrapper did (scratch of 2 ceil(cap / 1024) + 1 words, then
lane_valid = index < cap).

--kernels picks what is compared (default: all three):
- k1k2: K1 in its three with_stats modes and K2, on the adversarial 2 x 2
  tile records of tests/test_torch_footprint.py (`_tile_pairs`: thin,
  near-degenerate, faint, tile-wide and NaN splats, boxes ending on patch
  borders, a run saturating mid-chunk; seeds ADVERSARIAL_SEEDS, not timed)
  and on the main path's recorded calls of chip_smoke.py (generic frame 0
  of the 1920x1088 orbit on the 3.24M-point synthetic tree: K1 "weights"
  and False; training step 0: K1 "weights" and True, K2). K1 must equal
  the old version bit for bit, K2 agree within 1e-5 of its largest
  gradient (same non-finite entries) and repeat itself bit for bit;
- k5: K5 on the same adversarial records packed as K5's bf16 words
  (`_packed_tile_pairs`, with 16-byte and 4-byte staging) and on frame 0's
  calls of the flat_slice and block-pruned frames; bit for bit;
- k6: K6 on the adversarial masks of tests/test_torch_kernels_cuda.py
  (`COMPACT_EDGE_CASES`: k = 0, k = cap, cap = 1, a capacity that is not a
  multiple of 1024, more kept rows than k, more than 32 tiles per block)
  and on the flat_slice frame 0's compaction call under
  LOG_TPU_COMPACT=pallas; bit for bit against the old version and the
  plain version.
The recorded calls are timed in turns (old, new, new, old): CUDA events
around REPS calls after one warm-up (the host's gaps included) and, for
K5 and K6, torch.profiler's device time of every kernel the call launches.
Prints the card, each version's ptxas report and one JSON line, also
written to --out.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))  # the adversarial inputs

import chip_smoke as cs  # noqa: E402

REPS = 10
K2_REL_TOL = 1e-5
ADVERSARIAL_SEEDS = tuple(range(3, 11))
MODES = (False, "weights", True)
KERNEL_SETS = ("k1k2", "k5", "k6")
# the three-launch K6 interface (before the one-launch kernel)
_VP = ctypes.c_void_p
K6_THREE_LAUNCH_SIGNATURE = [_VP, ctypes.c_longlong, ctypes.c_int,
                             ctypes.POINTER(_VP), ctypes.c_int, _VP, _VP,
                             _VP, _VP]


class Version:
    """One version's library and which K6 interface it has."""

    def __init__(self, name, src, lib):
        self.name, self.src, self.lib = name, src, lib
        self.k6_three_launch = "void* valid" not in (
            src / "compact.cu").read_text()


def build_versions(src_dirs, out_dir):
    """{name: Version} for {name: csrc dir}: one nvcc per source of every
    version, all started together, then one link per version."""
    from log_tpu_torch.ops import kernels

    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = kernels._nvcc()
    procs = {}
    for name, d in src_dirs.items():
        for src in sorted(d.glob("*.cu")):
            obj = out_dir / f"ab_{name}.{src.stem}.o"
            procs[(name, src.name)] = (obj, subprocess.Popen(
                [nvcc, *kernels.NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {key: p.communicate()[0] for key, (_, p) in procs.items()}
    versions = {}
    for name, d in src_dirs.items():
        print(f"--- {name}: {d}")
        objs = []
        for (vname, src), (obj, p) in procs.items():
            if vname != name:
                continue
            for line in logs[(vname, src)].splitlines():
                if "Used" in line or "error" in line or "spill" in line:
                    print(f"  ptxas {src}: " + line.strip())
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name} {src}:\n"
                                   f"{logs[(vname, src)]}")
            objs.append(str(obj))
        lib = out_dir / f"libab_{name}.so"
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", str(lib), *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"link failed for {name}:\n{link.stderr}")
        cdll = ctypes.CDLL(str(lib))
        v = Version(name, d, cdll)
        for fn, argtypes in kernels._SIGNATURES.items():
            if fn == "log_stream_compact" and v.k6_three_launch:
                argtypes = K6_THREE_LAUNCH_SIGNATURE
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
        versions[name] = v
    return versions


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


def run_fwd(v, a, mode):
    from log_tpu_torch.ops import rasterize_tiled as rt

    with kernel_library(v.lib):
        return rt.rasterize_forward(*a, mode)


def run_bwd(v, args):
    from log_tpu_torch.ops import rasterize_tiled as rt

    with kernel_library(v.lib):
        return rt.rasterize_backward(*args)


def run_k5(v, a):
    from log_tpu_torch.ops import rasterize_tiled as rt

    with kernel_library(v.lib):
        return rt.rasterize_forward_packed(*a)


def run_k6(v, cols, keep, k):
    """K6 through the version's own interface."""
    import torch

    from log_tpu_torch.ops import compact, kernels

    if not v.k6_three_launch:
        with kernel_library(v.lib):
            return compact.stream_compact_cols(cols, keep, k)
    names = list(cols)
    cap = keep.shape[0]
    dev = keep.device
    n_blocks = -(-cap // compact.BLOCK_ROWS)
    out = torch.empty((len(names), k), dtype=torch.int32, device=dev)
    index = torch.empty((k,), dtype=torch.int32, device=dev)
    scratch = torch.empty((2 * n_blocks + 1,), dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * len(names))(
        *(cols[n].data_ptr() for n in names))
    rc = v.lib.log_stream_compact(
        kernels.ptr(keep), cap, k, ptrs, len(names), kernels.ptr(out),
        kernels.ptr(index), kernels.ptr(scratch), kernels.stream())
    kernels.check(rc, "stream_compact_cols")
    slices = {n: out[i].view(cols[n].dtype) for i, n in enumerate(names)}
    return slices, index, index < cap


def record_inputs(device, sel, log):
    """The recorded main-path calls that the selected comparisons replay:
    {"k1": [(call, mode, args)], "k2": args, "k5": [(call, args)],
    "k6": (cols, keep, k)}."""
    import torch

    from log_tpu_torch.render.renderer import NaiveRendererAndLoss
    from log_tpu_torch.utils.trainer import Trainer

    rec = {}
    model = cs.build_model(cs.N_ROOTS, device)
    renderer = NaiveRendererAndLoss(split="demo", device=device)
    batch = cs.orbit_batches(1)[0]
    if "k1k2" in sel:
        frame = cs.record_kernel_inputs(model, renderer, batch)
        k1 = cs.k1_calls_by_mode(frame)
        rec["k1"] = [("generic frame cull", "weights", k1["weights"]),
                     ("generic frame", False, k1[False])]
    if "k5" in sel or "k6" in sel:
        model.tree.cut_method = "flat_slice"
        model._refresh_device_caches()
        flat = cs.record_kernel_inputs(model, renderer, batch)
        rec["k5"] = [("flat_slice frame",
                      flat["rasterize_fwd_packed"][-1][0])]
        os.environ["LOG_TPU_COMPACT"] = "pallas"
        try:
            rec["k6"] = cs.record_kernel_inputs(
                model, renderer, batch)["stream_compact"][-1][0]
        finally:
            del os.environ["LOG_TPU_COMPACT"]
    if "k5" in sel:
        model.set_state(active_sh_degree=0)
        model.optimize_render_layout()
        model.set_state(check_render_every=cs.CHECK_RENDER_EVERY)
        block = cs.record_kernel_inputs(model, renderer, batch)
        rec["k5"].append(("block frame",
                          block["rasterize_fwd_packed"][-1][0]))
    del model, renderer
    torch.cuda.empty_cache()
    if "k1k2" in sel:
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
        k1 = cs.k1_calls_by_mode(step)
        rec["k1"] += [("training step cull", "weights", k1["weights"]),
                      ("training step", True, k1[True])]
        rec["k2"] = step["rasterize_bwd"][0][0]
    return rec


def adversarial_inputs(seed, device, packed=False, pstride_mult4=False):
    """K1's (or with packed, K5's) arguments on the adversarial records of
    one seed; pstride_mult4 pads the pair stride to a multiple of 4 (the
    16-byte staging; the records' own stride takes the 4-byte one)."""
    import torch

    from test_torch_footprint import _packed_tile_pairs, _tile_pairs

    pair, ts, tc, tiles_x, tiles_y = (_packed_tile_pairs if packed
                                      else _tile_pairs)(seed)
    if pstride_mult4:
        pad = -pair.shape[1] % 4
        pair = torch.cat([pair, pair.new_zeros((pair.shape[0], pad))], 1)
    return (pair.to(device), ts.to(device), tc.to(device),
            torch.tensor([0.1, 0.2, 0.3], device=device), tiles_x, tiles_y)


def same_bits(x, y):
    import torch

    return torch.equal(cs._bits(x), cs._bits(y))


def same_all(x, y):
    return all(same_bits(u, v) for u, v in zip(x, y))


def same_k6(x, y):
    import torch

    return (torch.equal(x[1], y[1]) and torch.equal(x[2], y[2])
            and all(same_bits(x[0][n], y[0][n]) for n in y[0]))


def k2_rel_err(new, old):
    """max |new - old| over old's largest finite gradient (rows 0-8), or
    inf where the non-finite entries differ."""
    import torch

    fin = torch.isfinite(old)
    if not torch.equal(fin, torch.isfinite(new)):
        return float("inf")
    scale = float(old[:9][fin[:9]].abs().max())
    return float((new[:9] - old[:9])[fin[:9]].abs().max()) / scale


def timed_turns(versions, run, device_time=False):
    """{"ms": mean per version, "turns_ms": [...], and with device_time
    "device_ms"/"device_turns_ms"}: run(v) timed in turns old, new, new,
    old."""
    times, dev = {"old": [], "new": []}, {"old": [], "new": []}
    for name in ("old", "new", "new", "old"):
        v = versions[name]
        times[name].append(cs.device_ms(lambda: run(v), REPS))
        if device_time:
            dev[name].append(cs.kernel_device_ms(lambda: run(v), REPS, "")[0])
    row = {"ms": {n: sum(t) / len(t) for n, t in times.items()},
           "turns_ms": times}
    if device_time:
        row["device_ms"] = {n: sum(t) / len(t) for n, t in dev.items()}
        row["device_turns_ms"] = dev
    return row


def compare_k1k2(versions, rec, log, failures):
    import torch

    old, new = versions["old"], versions["new"]
    out = {"k1": [], "k2": {}, "adversarial": []}
    # the adversarial records first: small, untimed
    for seed in ADVERSARIAL_SEEDS:
        a = adversarial_inputs(seed, "cuda")
        row = {"seed": seed, "k1_identical": {}}
        for mode in MODES:
            same = same_all(run_fwd(new, a, mode), run_fwd(old, a, mode))
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
        row["k2_reproducible"] = same_bits(g_new, run_bwd(new, bargs))
        if (row["k2_rel_err_to_old"] > K2_REL_TOL
                or not row["k2_reproducible"]):
            failures.append(f"K2 seed {seed}: {row}")
        log(f"adversarial seed {seed}: {row}")
        out["adversarial"].append(row)

    for call, mode, a in rec["k1"]:
        outs = {"old": run_fwd(old, a, mode), "new": run_fwd(new, a, mode)}
        same = same_all(outs["new"], outs["old"])
        row = {"call": call, "with_stats": mode,
               **timed_turns(versions, lambda v: run_fwd(v, a, mode)),
               "identical_to_old": same}
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
        out["k1"].append(row)

    k2_args = rec["k2"]
    grads = {"old": run_bwd(old, k2_args), "new": run_bwd(new, k2_args)}
    rel = k2_rel_err(grads["new"], grads["old"])
    row = {**timed_turns(versions, lambda v: run_bwd(v, k2_args)),
           "max_abs_old": float(grads["old"][:9].abs().max()),
           "rel_err_to_old": rel,
           "reproducible": same_bits(grads["new"], run_bwd(new, k2_args))}
    if rel > K2_REL_TOL or not row["reproducible"]:
        failures.append(f"K2 training step: rel err {rel}, "
                        f"reproducible {row['reproducible']}")
    log(f"K2 training step old {row['ms']['old']:.4f} ms, new "
        f"{row['ms']['new']:.4f} ms; rel err to old {rel:.3g}; "
        f"reproducible {row['reproducible']}")
    out["k2"] = row
    return out


def compare_k5(versions, rec, log, failures):
    from log_tpu_torch.ops import rasterize_tiled as rt

    old, new = versions["old"], versions["new"]
    out = {"adversarial": [], "calls": []}
    for seed in ADVERSARIAL_SEEDS:
        row = {"seed": seed}
        for mult4 in (False, True):
            a = adversarial_inputs(seed, "cuda", packed=True,
                                   pstride_mult4=mult4)
            got = run_k5(new, a)
            same = same_all(got, run_k5(old, a))
            plain = rt.rasterize_forward_packed_plain(*a)
            err = max(float((x - y).abs().max()) for x, y in zip(got, plain))
            row["vec16" if mult4 else "vec4"] = {"identical_to_old": same,
                                                 "max_abs_to_plain": err}
            if not same or err > cs.K1_MAX_ABS:
                failures.append(f"K5 seed {seed} (16-byte staging {mult4}):"
                                f" identical {same}, max_abs {err}")
        log(f"K5 adversarial seed {seed}: {row}")
        out["adversarial"].append(row)
    for call, a in rec["k5"]:
        same = same_all(run_k5(new, a), run_k5(old, a))
        row = {"call": call, "pairs": a[0].shape[1],
               **timed_turns(versions, lambda v: run_k5(v, a), True),
               "identical_to_old": same}
        if not same:
            failures.append(f"K5 {call} differs from the old version")
        runs = a[2].float()
        row["tiles"] = {"run_max": float(runs.max()),
                        "run_mean": float(runs.mean())}
        log(f"K5 {call:18s} old {row['ms']['old']:.4f} ms (device "
            f"{row['device_ms']['old']:.4f}), new {row['ms']['new']:.4f} ms "
            f"(device {row['device_ms']['new']:.4f}); identical to old "
            f"{same}")
        out["calls"].append(row)
    return out


def compare_k6(versions, rec, log, failures):
    from test_torch_kernels_cuda import COMPACT_EDGE_CASES, _compact_inputs

    from log_tpu_torch.ops import compact

    old, new = versions["old"], versions["new"]
    out = {"adversarial": [], "frame": {}}
    for cap, k, density in COMPACT_EDGE_CASES:
        cols, keep = _compact_inputs("cuda", cap, density, cap % 1000)
        got = run_k6(new, cols, keep, k)
        row = {"cap": cap, "k": k, "kept": int(keep.sum()),
               "identical_to_old": same_k6(got, run_k6(old, cols, keep, k)),
               "identical_to_plain": same_k6(
                   got, compact.stream_compact_cols_plain(cols, keep, k))}
        if not (row["identical_to_old"] and row["identical_to_plain"]):
            failures.append(f"K6 {row}")
        log(f"K6 adversarial {row}")
        out["adversarial"].append(row)
    cols, keep, k = rec["k6"]
    got = run_k6(new, cols, keep, k)
    same = same_k6(got, run_k6(old, cols, keep, k))
    exact = same_k6(got, compact.stream_compact_cols_plain(cols, keep, k))
    row = {"cap": keep.shape[0], "k": k, "columns": len(cols),
           "kept": int(keep.sum()),
           **timed_turns(versions, lambda v: run_k6(v, cols, keep, k), True),
           "identical_to_old": same, "identical_to_plain": exact}
    if not (same and exact):
        failures.append(f"K6 flat_slice frame: identical to old {same}, "
                        f"to plain {exact}")
    log(f"K6 flat_slice frame cap={row['cap']} k={k} kept={row['kept']}: "
        f"old {row['ms']['old']:.4f} ms (device "
        f"{row['device_ms']['old']:.4f}), new {row['ms']['new']:.4f} ms "
        f"(device {row['device_ms']['new']:.4f}); identical to old {same}, "
        f"to plain {exact}")
    out["frame"] = row
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, type=Path)
    ap.add_argument("--kernels", default=",".join(KERNEL_SETS),
                    help="comma list of " + ", ".join(KERNEL_SETS))
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "ab_k1_k2.json")
    opt = ap.parse_args()
    sel = set(opt.kernels.split(","))
    if not sel <= set(KERNEL_SETS):
        ap.error(f"--kernels: unknown {sorted(sel - set(KERNEL_SETS))}")
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
    versions = build_versions({"old": opt.old.resolve(), "new": CSRC},
                              ROOT / "build" / "ab")
    log(f"built {len(versions)} versions in {time.perf_counter() - t0:.1f} s")
    result = {"card": smi, "reps": REPS, "kernels": sorted(sel)}
    failures = []
    with torch.no_grad():
        rec = record_inputs("cuda", sel, log)
        if "k1k2" in sel:
            result.update(compare_k1k2(versions, rec, log, failures))
        if "k5" in sel:
            result["k5"] = compare_k5(versions, rec, log, failures)
        if "k6" in sel:
            result["k6"] = compare_k6(versions, rec, log, failures)
    result["failures"] = failures
    opt.out.parent.mkdir(parents=True, exist_ok=True)
    opt.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    for f in failures:
        print("FAIL: " + f, file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
