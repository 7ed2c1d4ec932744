"""Row-gather cost of the compaction's gathers in four layouts;
counterpart of scripts/bench_gathercost.py.

After a key sort, the compaction gathers the attribute columns at the k
kept (monotone) indices of a capacity axis of CAP rows:

  g1: 8 separate 1-D takes, one per int32 column;
  g2: one (cap, 8) int32 row gather;
  g3: one (cap, 16) f32 row gather;
  g4: one (cap, 128) f32 row gather.

The JAX script's worry, that XLA deletes unused gather results, does not
arise in eager torch, where every op runs as called, so the timed call is
the gathers alone; every output is then consumed by a position-weighted
checksum, checked against the host's gather of the same rows.

    python -m log_tpu_torch.scripts.bench_gathercost [--reps R]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from . import _common as C

CAP = 1 << 22
KS = (1 << 19, 1 << 21)


def checksum(x):
    w = torch.arange(x.shape[0], dtype=torch.float64, device=x.device) * 1e-9
    return (x.to(torch.float64).reshape(x.shape[0], -1).sum(-1) * w).sum()


def g1(cols, idx):
    return [c[idx] for c in cols]


def g2(mat, idx):
    return mat[idx]


def run(cap: int = CAP, ks=KS, reps: int = 10, device=None) -> dict:
    dev = C.resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(C.SEED)
    cols8 = torch.randint(0, 1 << 30, (8, cap), generator=gen, device=dev,
                          dtype=torch.int32)
    mats = {"g2": cols8.T.contiguous(),
            "g3": torch.randn((cap, 16), generator=gen, device=dev),
            "g4": torch.randn((cap, 128), generator=gen, device=dev)}
    rows = []
    for k in ks:
        # a monotone subset, as a compaction's permutation is
        idx = torch.sort(torch.randperm(cap, generator=gen, device=dev)[:k]
                         ).values
        idx_np = idx.cpu().numpy()
        wn = np.arange(k, dtype=np.float64) * 1e-9
        cases = [("g1", lambda: g1(cols8, idx), cols8.T)]
        cases += [(name, lambda m=m: g2(m, idx), m) for name, m in
                  mats.items()]
        for name, fn, mat in cases:
            want = float((mat.cpu().numpy()[idx_np].astype(np.float64)
                          .reshape(k, -1).sum(-1) * wn).sum())
            res = fn()
            got = float(checksum(torch.stack(res, dim=1) if name == "g1"
                                 else res))
            r = C.time_stage(f"{name}_k{k}", fn, reps, dev)
            r.update(layout=name, k=k, checksum_ok=bool(
                abs(got - want) <= 1e-9 * max(1.0, abs(want))))
            rows.append(r)
    out = {"metric": "gather_cost", "card": C.card_line(dev), "cap": cap,
           "rows": rows}
    if not all(r["checksum_ok"] for r in rows):
        raise RuntimeError("a gathered output differs from the host's")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    C.emit(run(reps=ap.parse_args(argv).reps))


if __name__ == "__main__":
    main()
