"""Run a function on every rank of a gloo process group, on the CPU.

``spawn(fn, world, tmp_path, *args)`` starts ``world`` processes (the
``spawn`` start method), each with one torch thread, joins them to a gloo
group through a file in ``tmp_path`` (no network), calls
``fn(rank, world, *args)`` and returns the ranks' results in rank order.
A rank that raises fails the caller with its traceback; a run past
``timeout`` seconds is killed and fails. ``fn`` must be a module-level
function of an importable module.
"""

from __future__ import annotations

import os
import queue
import traceback

import torch.multiprocessing as mp


def _entry(fn, rank, world, init, q, args):
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        q.put((rank, True, out))
    except Exception:  # noqa: BLE001 - reported to the parent
        q.put((rank, False, traceback.format_exc()))


def spawn(fn, world: int, tmp_path, *args, timeout: float = 420.0):
    os.makedirs(str(tmp_path), exist_ok=True)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = f"file://{os.path.join(str(tmp_path), 'pg_init')}"
    procs = [ctx.Process(target=_entry, args=(fn, r, world, init, q, args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):
            rank, ok, out = q.get(timeout=timeout)
            if ok:
                results[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
    except queue.Empty:
        errors.append(f"ranks {sorted(set(range(world)) - set(results))} "
                      f"gave no result within {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=5 if not errors else 0.1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise AssertionError(errors[0])
    return [results[r] for r in range(world)]
