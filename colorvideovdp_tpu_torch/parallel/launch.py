"""Start ranks of a ``torch.distributed`` program on one host.

The counterpart of the process handling of the JAX package's multi-device dry
run (``__graft_entry__.py:39-76``, which re-executes itself with a virtual
device count): ``run_ranks(target, world, args)`` spawns ``world`` processes
(``torch.multiprocessing``, "spawn"), each of which joins a process group
that meets at ``file://<tmpdir>/rdv`` and calls ``target(rank, world,
*args)``; it returns every rank's result, in rank order.

* ``device`` ("cuda", the default, or "cpu") is the one place a rank's device
  is set: rank r gets card r modulo the card count, and a target reads its
  device with ``rank_device()``.
* The kernel library is built once, in the parent, before the ranks start.
* Backend: NCCL when every rank has a card of its own, gloo otherwise (on
  the CPU, or several ranks sharing a card: NCCL refuses two ranks on one
  card). The choice is made up front and printed; nothing retries.
* A rank that raises makes ``run_ranks`` raise with its traceback: the parent
  then kills the ranks that still wait in a collective. The process group's
  ``timeout`` and the parent's deadline bound every other way to hang.

Targets are functions of this package (``sharding.score_rank``,
``sharding.reduce_rank``, ``sharding.expand_rank``, ``run_jobs``,
``fail_rank``), so that a spawned child imports only the package.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def pick_backend(world: int, device: str, n_cards: int) -> str:
    """"nccl" when every one of ``world`` ranks has a card of its own, else
    "gloo"."""
    return "nccl" if device == "cuda" and n_cards >= world else "gloo"


def device_map(world: int, device: str, n_cards: int):
    """The card index of each rank (rank modulo the card count), or None on
    the CPU."""
    if device == "cpu":
        return [None] * world
    if n_cards < 1:
        raise RuntimeError("run_ranks: device 'cuda' requested but no card is visible")
    return [r % n_cards for r in range(world)]


# This rank's device, set by ``_worker`` before the target runs.
_RANK_DEVICE = None


def rank_device() -> torch.device:
    """The device ``run_ranks`` gave this rank: its card, or the CPU."""
    if _RANK_DEVICE is None:
        raise RuntimeError("rank_device: not inside a rank started by run_ranks")
    return _RANK_DEVICE


def _worker(rank, world, rdv, backend, card, timeout_s, target, args, out):
    global _RANK_DEVICE
    try:
        if card is None:
            torch.set_num_threads(1)
            _RANK_DEVICE = torch.device("cpu")
        else:
            torch.cuda.set_device(card)
            _RANK_DEVICE = torch.device("cuda", card)
        dist.init_process_group(backend, init_method=rdv, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
        result = target(rank, world, *args)
        out.put((rank, True, result))
    except BaseException:  # reported to the parent, which raises it
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(target, world: int, args=(), backend: str | None = None, timeout_s: float = 600,
              device: str = "cuda"):
    """Run ``target(rank, world, *args)`` in ``world`` spawned processes, each
    in one process group; returns the list of the ranks' results. ``device``
    "cuda" (the default) gives rank r the card r modulo the card count;
    "cpu" keeps every rank on the host. Raises if a rank raises or dies, or
    when ``timeout_s`` has passed."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"run_ranks: device must be 'cuda' or 'cpu', not {device!r}")
    n_cards = torch.cuda.device_count() if device == "cuda" else 0
    cards = device_map(world, device, n_cards)
    backend = backend or pick_backend(world, device, n_cards)
    if device == "cuda":
        from ..ops.kernels import _build

        _build.library()
    print(f"run_ranks: {world} ranks, backend {backend}, "
          + ("CPU" if device == "cpu" else f"cards {cards}"), flush=True)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="cvvdp_ranks_")
    rdv = "file://" + os.path.join(tmp, "rdv")
    out = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(r, world, rdv, backend, cards[r], timeout_s,
                                               target, tuple(args), out), daemon=True)
             for r in range(world)]
    results, failure = {}, None
    deadline = time.time() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(results) < world and failure is None:
            try:
                rank, ok, value = out.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and not p.is_alive() and p.exitcode != 0]
                if dead:
                    failure = f"rank {dead[0]} died with exit code {procs[dead[0]].exitcode}"
                elif time.time() > deadline:
                    failure = f"ranks {sorted(set(range(world)) - set(results))} " \
                              f"not done after {timeout_s} s"
                continue
            if ok:
                results[rank] = value
            else:
                failure = f"rank {rank} raised:\n{value}"
        if failure is None:
            for p in procs:
                p.join(max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(f"run_ranks: {failure}")
    return [results[r] for r in range(world)]


def run_jobs(rank: int, world: int, jobs):
    """Rank target: several ``(target, args)`` jobs in one process group, in
    order; returns their results."""
    return [target(rank, world, *args) for target, args in jobs]


def fail_rank(rank: int, world: int, bad: int):
    """Rank target for the failure path: rank ``bad`` raises while the others
    wait in a collective that it never joins."""
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.all_reduce(torch.ones(1, device=rank_device()))
    return rank
