"""Starting the ranks of a multi-device run: one process per rank on `torch.distributed`.

The JAX package runs every mesh from one process with `shard_map`; the port runs one
process per rank, each executing the body the JAX `shard_fn` holds, with the JAX
collectives as `collectives.py` calls.

  - `spawn(target, args, world, ...)` starts `world` processes with the `spawn` start
    method (CUDA rules out `fork`), sets each one up (`init_rank`) and calls
    `target(*args)` in it; `target` must be a module-level function of this package, so
    it pickles by reference and a child imports nothing else. It returns every rank's
    return value (pickled through files in a temporary directory). A rank that raises
    ends the run: the others are terminated and `RankFailed` carries the traceback of
    the rank that failed first (each failing rank stamps its own, so a peer whose
    collective broke when that rank exited is not taken for it); a run that outlives
    `run_timeout` is terminated too.
  - Under `torchrun` (RANK and WORLD_SIZE set), `init_from_env` sets the process up in
    place.
  - Rank r uses `cuda:{r % device_count}`, or the CPU when asked for it.
  - Rendezvous goes through a file store in a temporary directory (no TCP port), and
    every process group gets a timeout.
  - Backend: NCCL on cards when every rank has its own card, gloo on the CPU or when
    ranks share a card; `choose_backend` refuses NCCL with more ranks than cards.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

#: default timeout of a process group's collectives (seconds)
GROUP_TIMEOUT = 1800.0

_device: torch.device | None = None     # this process's rank device, once set up


class RankFailed(RuntimeError):
    """A rank of a spawned run raised or died; the message holds its traceback."""


def choose_backend(asked: str | None, device_type: str, world: int) -> str:
    """The process group's backend: `asked`, or NCCL on cards and gloo on the CPU.
    NCCL needs a card per rank and refuses CPU tensors."""
    backend = asked or ("nccl" if device_type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl or gloo, got {backend!r}")
    if backend == "nccl":
        if device_type != "cuda":
            raise ValueError("NCCL runs on CUDA cards only; use --dist_backend gloo "
                             "with --device cpu")
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(
                f"NCCL needs one card per rank: {world} ranks, {cards} card(s); pass "
                f"--dist_backend gloo to let the ranks share the card(s)")
    return backend


def rank_device(rank: int, device_type: str) -> torch.device:
    """cuda:{rank % device_count} for CUDA, else the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(device_type)


def under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_rank(rank: int, world: int, store: str, backend: str, device_type: str,
              timeout: float = GROUP_TIMEOUT) -> torch.device:
    """Join the process group of a spawned run through the file store `store`; returns
    this rank's device."""
    global _device
    _device = rank_device(rank, device_type)
    if _device.type == "cuda":
        torch.cuda.set_device(_device)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    return _device


def init_from_env(backend: str | None, device_type: str,
                  timeout: float = GROUP_TIMEOUT) -> torch.device:
    """Join the process group torchrun describes (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT); returns this rank's device."""
    global _device
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    backend = choose_backend(backend, device_type, world)
    _device = rank_device(int(os.environ.get("LOCAL_RANK", rank)), device_type)
    if _device.type == "cuda":
        torch.cuda.set_device(_device)
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    return _device


def current_device() -> torch.device | None:
    """This process's rank device (None outside a run set up here)."""
    return _device


def _child(rank, world, workdir, backend, device_type, threads, timeout, target, args):
    """The body of a spawned rank (module level, so it pickles by reference)."""
    torch.set_num_threads(threads)
    init_rank(rank, world, os.path.join(workdir, "store"), backend, device_type,
              timeout)
    try:
        result = target(*args)
        path = os.path.join(workdir, f"rank{rank}.pt")
        torch.save(result, path + ".tmp")
        os.replace(path + ".tmp", path)
    except BaseException:
        # stamped before this rank exits: a peer whose collective breaks when it does
        # fails later, so `spawn` can name the rank that failed first
        path = os.path.join(workdir, f"rank{rank}.err")
        with open(path + ".tmp", "w") as fh:
            fh.write(f"{time.time_ns()}\n{traceback.format_exc()}")
        os.replace(path + ".tmp", path)
        raise
    finally:
        dist.destroy_process_group()


def _first_failure(workdir: str) -> str | None:
    """'rank r raised:' and the traceback of the rank that failed first, from the
    stamped files of `_child`; None when no rank left one."""
    found = []
    for name in os.listdir(workdir):
        if name.startswith("rank") and name.endswith(".err"):
            with open(os.path.join(workdir, name)) as fh:
                stamp, _, trace = fh.read().partition("\n")
            found.append((int(stamp), int(name[4:-4]), trace))
    if not found:
        return None
    _, rank, trace = min(found)
    return f"rank {rank} raised:\n{trace}"


def spawn(target, args: tuple, world: int, *, device_type: str = "cuda",
          backend: str | None = None, group_timeout: float = GROUP_TIMEOUT,
          run_timeout: float | None = None, threads: int | None = None) -> list:
    """Run `target(*args)` on `world` fresh processes joined in one process group;
    returns the ranks' return values in rank order. `threads`: torch intra-op threads a
    rank (default: this process's share, at least 1)."""
    import torch.multiprocessing as mp

    backend = choose_backend(backend, device_type, world)
    threads = threads or max(1, torch.get_num_threads() // world)
    workdir = tempfile.mkdtemp(prefix="langsplat_ranks_")
    try:
        ctx = mp.start_processes(
            _child, args=(world, workdir, backend, device_type, threads, group_timeout,
                          target, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = None if run_timeout is None else time.monotonic() + run_timeout
        try:
            while not ctx.join(timeout=0.5):
                if deadline is not None and time.monotonic() > deadline:
                    raise RankFailed(f"the {world}-rank run outlived its "
                                     f"{run_timeout:.0f} s and was terminated")
        except mp.ProcessRaisedException as e:
            # the exception `join` met first may be a peer's broken collective
            raise RankFailed(_first_failure(workdir)
                             or f"rank {e.error_index} raised:\n{e}") from None
        except mp.ProcessExitedException as e:
            raise RankFailed(f"rank {e.error_index} exited with code {e.exit_code}"
                             ) from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(5)
                if p.is_alive():
                    p.kill()
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
