"""Sort cost against payload count, as the port sorts; counterpart of
scripts/bench_sortcost.py.

The port's binning and compaction sort one int64 key (`torch.sort`, which
also returns the permutation) and then gather each payload column by the
permutation. This times that for n keys and p f32 payloads. The JAX
script's worry, that XLA drops sort operands whose outputs go unused,
does not arise in eager torch, where every op runs as called, so the
timed call is the sort and the gathers alone; every output is then
consumed by a position-weighted checksum, checked against a host sort of
the same data.

    python -m log_tpu_torch.scripts.bench_sortcost [--reps R]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from . import _common as C

SIZES = (1 << 20, 1 << 21, 3 << 20, 1 << 22)
PAYLOADS = (1, 3, 7, 11, 15)


def sort_payloads(key, vals, p: int):
    """The sorted key and p payload columns gathered by its permutation."""
    key_s, perm = torch.sort(key)
    return [key_s] + [vals[i][perm] for i in range(p)]


def checksum(outs):
    """Every output, position-weighted, summed in float64."""
    w = torch.arange(outs[0].shape[0], dtype=torch.float64,
                     device=outs[0].device) * 1e-9
    return float(sum((o.to(torch.float64) * w).sum() for o in outs))


def run(sizes=SIZES, payloads=PAYLOADS, reps: int = 10, device=None) -> dict:
    dev = C.resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(C.SEED)
    rows = []
    for n in sizes:
        key = torch.randint(0, 1 << 62, (n,), generator=gen, device=dev)
        vals = torch.randn((max(payloads), n), generator=gen, device=dev)
        # the checksum against a host sort of the same data (stable order
        # does not matter: the keys are distinct with high probability)
        k_np, v_np = key.cpu().numpy(), vals.cpu().numpy()
        order = np.argsort(k_np, kind="stable")
        wn = np.arange(n, dtype=np.float64) * 1e-9
        for p in payloads:
            got = checksum(sort_payloads(key, vals, p))
            want = float((k_np[order].astype(np.float64) * wn).sum()
                         + sum((v_np[i][order].astype(np.float64) * wn).sum()
                               for i in range(p)))
            r = C.time_stage(f"n{n}_p{p}", lambda: sort_payloads(key, vals,
                                                                 p),
                             reps, dev)
            r.update(n=n, payloads=p, checksum_ok=bool(
                abs(got - want) <= 1e-9 * max(1.0, abs(want))))
            rows.append(r)
    out = {"metric": "sort_cost", "card": C.card_line(dev), "rows": rows}
    if not all(r["checksum_ok"] for r in rows):
        raise RuntimeError("a sorted output differs from the host sort")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    C.emit(run(reps=ap.parse_args(argv).reps))


if __name__ == "__main__":
    main()
