"""Run a function in a group of CPU ranks joined by gloo, for the port's
parallel tests.

Each rank is a spawned process that joins a process group through a file
under the test's directory (no port), runs ``fn(rank, world, workdir)``
and exits. A rank that raises writes its traceback next to the store; the
first rank to fail ends the others, and a group that outlives its timeout
is ended too, so every join has a limit. Imports no JAX: the ranks import
this module and the test module that names ``fn``.
"""

from __future__ import annotations

import multiprocessing
import os
import time
import traceback
from pathlib import Path

import torch.distributed as dist


def _entry(fn, rank: int, world: int, workdir: str) -> None:
    try:
        from twotowers_tpu_torch.parallel import initialize_distributed

        initialize_distributed(f"file://{workdir}/store", world, rank, device_type="cpu")
        fn(rank, world, Path(workdir))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        Path(workdir, f"error.r{rank}.txt").write_text(traceback.format_exc())
        raise


def spawn_ranks(fn, world: int, workdir: Path, timeout: float = 180.0) -> None:
    """Run ``fn`` on ``world`` gloo ranks; raise if any rank fails or the
    group does not end within ``timeout`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # ranks share the worker's cores
    try:
        procs = [ctx.Process(target=_entry, args=(fn, r, world, str(workdir)))
                 for r in range(world)]
        for p in procs:
            p.start()
    finally:
        if saved is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = saved
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    errors = sorted(Path(workdir).glob("error.r*.txt"))
    if errors:
        raise AssertionError(f"{errors[0].name}:\n{errors[0].read_text()}")
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"ranks ended with exit codes {codes} "
                             f"(timeout {timeout} s)")
