"""Start n ranks of a function in n processes, each in one process group,
and collect what they return; for tests and the smoke run.

    results = spawn(fn, world, device="cuda", args=(...), timeout_s=120)

runs fn(rank, world, rank_device, *args) in `world` processes started with
torch.multiprocessing's spawn method (fn and args must pickle: a function
at the top level of an importable module). The group meets over a FileStore
in a fresh temporary directory, so that concurrent launches never share a
port. device "cuda" (the default): NCCL, rank r on card r, the kernel
library built here once before any rank starts (the ranks load it);
"cpu": gloo, one thread per rank. Returns the ranks' return values in rank
order. Raises if a rank raises, dies, or the ranks outlive timeout_s; every
rank is stopped first.
"""
from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, world, device, store_path, timeout_s, fn, args, out):
    try:
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(rank)
            device = torch.device("cuda", rank)
            backend = "nccl"
        else:
            torch.set_num_threads(1)
            backend = "gloo"
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=timeout_s))
        try:
            result = fn(rank, world, device, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:  # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world: int, device="cuda", args=(),
          timeout_s: float = 120.0):
    if torch.device(device).type == "cuda":
        from ..ops import kernels

        kernels.build()
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="log_tpu_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, str(device), store, timeout_s,
                                   fn, args, out), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        results, error = {}, None
        deadline = time.monotonic() + timeout_s
        try:
            # drain the queue before joining: a rank blocks on exit until
            # its result has been read
            while len(results) < world and error is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    error = (f"ranks {sorted(set(range(world)) - set(results))}"
                             f" still running after {timeout_s:.0f} s")
                    break
                try:
                    rank, ok, payload = out.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in results and p.exitcode not in (None, 0)]
                    if dead:
                        error = f"ranks {dead} died without a result"
                    continue
                if ok:
                    results[rank] = payload
                else:
                    error = f"rank {rank} failed:\n{payload}"
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 5.0)
                       if error is None else 1.0)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    if error is None:
        stuck = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if stuck:
            error = f"ranks {stuck} exited with {[procs[r].exitcode for r in stuck]}"
    if error is not None:
        raise RuntimeError(f"spawn({getattr(fn, '__name__', fn)}, {world}): "
                           f"{error}")
    return [results[r] for r in range(world)]
