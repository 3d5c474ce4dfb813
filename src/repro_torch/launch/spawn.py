"""A spawner for several ranks on one host: the port's counterpart of
``torchrun`` for tests and ``chip_smoke.py``.

``run_ranks(fn, world, ...)`` starts ``world`` processes (``spawn``), each
joins a process group through a ``FileStore`` (no fixed port, so that
several groups can run side by side), calls ``fn(rank, world, *args)`` and
sends back what it returns (picklable: numbers, numpy arrays).  A rank that
raises, dies, or has not answered by ``timeout`` seconds makes the parent
kill every rank and raise: a rank stuck in a collective fails the caller,
it does not hang it.

On a host with one rank per card, ``torchrun --nproc-per-node N`` with
``make_mesh(..., backend="nccl")`` is the production launcher; this one
takes the backend it is given (gloo on the CPU, or several ranks sharing
one card).
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Callable


def _rank_main(fn, rank, world, backend, store_path, timeout, args, results):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)  # the ranks share the host's cores
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # noqa: BLE001 -- reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, *args, backend: str = "gloo",
              timeout: float = 300.0, store_dir=None) -> list:
    """[fn(0, world, *args), ..., fn(world - 1, world, *args)], each run in
    its own process inside a process group of ``backend``; ``timeout``
    bounds the whole run and each collective.  ``fn`` must be importable by
    name (a module-level function).  The ``FileStore`` lies in a temporary
    directory under ``store_dir`` (the system's by default)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, backend, store_path, timeout, args,
                                   results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got: dict = {}
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if r not in got
                            and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result")
                    if time.monotonic() > deadline:
                        missing = sorted(set(range(world)) - set(got))
                        raise TimeoutError(f"ranks {missing} did not finish in {timeout} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{out}")
                got[rank] = out
            for p in procs:
                p.join(timeout=30)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    return [got[r] for r in range(world)]
