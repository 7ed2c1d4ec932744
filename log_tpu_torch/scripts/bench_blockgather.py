"""Cost of block takes, axis-0 takes of (B, S) arrays; counterpart of
scripts/bench_blockgather.py.

The block-pruned frame takes its eligible S-row blocks to the front
before the projection and the compaction, so its per-frame stages scale
with the visible blocks and not with the capacity. That pays only if a
block take runs near the memory rate. This times the take of k_b of the
B = CAP / S blocks of 14 f32 columns, against a dense read of all of
them. The JAX script's worry, that XLA simplifies away a take whose
result feeds a permutation-invariant sum, does not arise in eager torch,
where every op runs as called, so the timed call is the takes (or the
dense copy) alone; every output is then consumed by a position-weighted
checksum, checked against the host's take.

    python -m log_tpu_torch.scripts.bench_blockgather [--reps R]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from . import _common as C

CAP = 1 << 22
S = 4096
N_COLS = 14
KBS = (64, 128, 256, 512, 896)


def take_all(cols, idx):
    return [c[idx] for c in cols]


def dense(cols):
    """A read and a write of every column: the memory rate's reference."""
    return [c.clone() for c in cols]


def checksum(outs):
    w = torch.arange(outs[0].numel(), dtype=torch.float64,
                     device=outs[0].device)
    return float(sum((o.reshape(-1).to(torch.float64) * w).sum()
                     for o in outs))


def run(cap: int = CAP, s: int = S, kbs=KBS, reps: int = 10,
        device=None) -> dict:
    dev = C.resolve_device(device)
    B = cap // s
    gen = torch.Generator(device=dev).manual_seed(C.SEED)
    cols = [torch.randn((B, s), generator=gen, device=dev)
            for _ in range(N_COLS)]
    host = [c.cpu().numpy().astype(np.float64) for c in cols]
    r = C.time_stage("dense", lambda: dense(cols), reps, dev)
    r.update(rows=cap, mbytes=cap * N_COLS * 4 / 1e6, checksum_ok=bool(
        checksum(dense(cols)) == checksum(cols)))
    rows = [r]
    rng = np.random.default_rng(C.SEED)
    for kb in kbs:
        if kb > B:
            continue
        idx_np = np.sort(rng.permutation(B)[:kb])
        idx = torch.from_numpy(idx_np).to(dev)
        wn = np.arange(kb * s, dtype=np.float64)
        want = sum(float((h[idx_np].reshape(-1) * wn).sum()) for h in host)
        got = checksum(take_all(cols, idx))
        r = C.time_stage(f"take_kb{kb}", lambda: take_all(cols, idx), reps,
                         dev)
        r.update(k_blocks=kb, rows=kb * s, mbytes=kb * s * N_COLS * 4 / 1e6,
                 checksum_ok=bool(abs(got - want)
                                  <= 1e-9 * max(1.0, abs(want))))
        rows.append(r)
    out = {"metric": "block_take_cost", "card": C.card_line(dev), "cap": cap,
           "S": s, "cols": N_COLS, "rows": rows}
    if not all(r["checksum_ok"] for r in rows):
        raise RuntimeError("a block take differs from the host's")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    C.emit(run(reps=ap.parse_args(argv).reps))


if __name__ == "__main__":
    main()
