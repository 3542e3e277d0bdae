"""Run one function on N local ranks, each in its own process (the
in-process counterpart of ``torchrun --nproc-per-node N``).

``run_ranks(fn, n, *args)`` spawns ``n`` processes (the ``spawn`` start
method), each of which brings up the process group with
:func:`tvc_torch.parallel.mesh.initialize_multihost` (a ``file://``
rendezvous in the run directory unless a coordinator is given), calls
``fn(rank, n, *args)`` and writes its return value to the run directory;
the parent collects the values in rank order. ``args`` go through one
file in the run directory, not the children's start-up pipes (a large
argument written into a pipe would hold each start until the child before
has booted). ``fn`` must be importable by
its module path (the children import it afresh). Every join has a
deadline: a rank still running after ``timeout`` seconds is killed, with
every other, and the call raises. ``one_rank()`` brings up a one-rank
group in the calling process instead (world size 1, torn down on exit).
"""

from __future__ import annotations

import multiprocessing
import pickle
import tempfile
import time
import traceback
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Callable, Iterator, List, Optional


def _child(fn, rank: int, n: int, run_dir: str, coordinator: Optional[str], device, backend,
           threads: Optional[int]) -> None:
    out = Path(run_dir) / f"rank{rank}.pkl"
    try:
        with open(Path(run_dir) / "args.pkl", "rb") as f:  # written by run_ranks
            args = pickle.load(f)
        import torch
        import torch.distributed as dist

        from tvc_torch.parallel.mesh import initialize_multihost

        if threads:
            torch.set_num_threads(threads)
        initialize_multihost(coordinator or f"file://{run_dir}/store", n, rank, device=device, backend=backend)
        try:
            value = ("ok", fn(rank, n, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        value = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(value, f)


def run_ranks(
    fn: Callable[..., Any],
    n: int,
    *args,
    device=None,
    backend: Optional[str] = None,
    coordinator: Optional[str] = None,
    threads: Optional[int] = None,
    timeout: float = 120.0,
    run_dir: Optional[str] = None,
) -> List[Any]:
    """``[fn(0, n, *args), ..., fn(n-1, n, *args)]``, each on its own rank.

    ``device`` / ``backend`` go to ``initialize_multihost`` (None: the card
    over NCCL; ``device="cpu"``: gloo). ``threads``: torch's intra-op
    threads in each child. Raises ``RuntimeError`` with the children's
    tracebacks when a rank fails, ``TimeoutError`` when one outlives
    ``timeout``."""
    run_dir = run_dir or tempfile.mkdtemp(prefix="tvc_ranks_")
    with open(Path(run_dir) / "args.pkl", "wb") as f:
        pickle.dump(args, f)
    ctx = multiprocessing.get_context("spawn")
    procs = [
        ctx.Process(target=_child, args=(fn, r, n, run_dir, coordinator, device, backend, threads))
        for r in range(n)
    ]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        if late:
            raise TimeoutError(f"ranks {late} of {n} still running after {timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    results, errors = [], []
    for r, p in enumerate(procs):
        path = Path(run_dir) / f"rank{r}.pkl"
        if not path.exists():
            errors.append(f"rank {r} exited with code {p.exitcode} and no result")
            continue
        with open(path, "rb") as f:  # written by the child above
            status, value = pickle.load(f)
        if status != "ok":
            errors.append(f"rank {r}:\n{value}")
        results.append(value)
    if errors:
        raise RuntimeError("\n".join(errors))
    return results


@contextmanager
def one_rank(device=None, backend: Optional[str] = None, run_dir: Optional[str] = None) -> Iterator[None]:
    """A one-rank process group in this process (a ``file://`` rendezvous
    in ``run_dir``), destroyed on exit: the mesh paths at world size 1."""
    import torch.distributed as dist

    from tvc_torch.parallel.mesh import initialize_multihost

    run_dir = run_dir or tempfile.mkdtemp(prefix="tvc_rank_")
    initialize_multihost(f"file://{run_dir}/store", 1, 0, device=device, backend=backend)
    try:
        yield
    finally:
        dist.destroy_process_group()
