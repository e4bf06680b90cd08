"""Process bootstrap for multi-rank runs, the counterpart of
``recombiner_tpu/parallel/launch.py`` on ``torch.distributed``.

One process per rank, each on its own card (``cuda:LOCAL_RANK``, NCCL) or,
with ``--device cpu``, on the CPU (gloo). Three ways to start one:

- ``--n_devices N`` (N > 1) with no launcher: the CLI spawns N local ranks
  (``spawn``, start method ``spawn``; a rendezvous file in a temporary
  directory) and the parent waits for them;
- the JAX package's env gate, with the same names honoured, one command
  per process::

      RECOMBINER_TPU_MULTIHOST=1 RECOMBINER_TPU_COORDINATOR=host0:29500 \\
      RECOMBINER_TPU_NUM_PROCESSES=2 RECOMBINER_TPU_PROCESS_ID=0 \\
          python -m recombiner_tpu_torch.cli.train ...

  (the coordinator becomes ``MASTER_ADDR:MASTER_PORT``, the process count
  ``WORLD_SIZE``, the process id ``RANK``);
- torchrun, whose environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``) starts a group by itself::

      torchrun --nproc_per_node 2 -m recombiner_tpu_torch.cli.train ...

At world size 1 with no launcher no process group is started, so a
single-device run is what it was. Rank 0 writes every file
(``is_primary``); ``fetch_global`` gathers row shards on every rank.
"""

from __future__ import annotations

import datetime
import importlib
import os
import shutil
import tempfile
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

GATE = "RECOMBINER_TPU_MULTIHOST"
COLLECTIVE_TIMEOUT_S = 1800.0  # torch's own default for gloo and NCCL


def multihost_enabled() -> bool:
    return os.environ.get(GATE, "0").lower() in ("1", "true", "yes")


def launched() -> bool:
    """The env gate is on, or torchrun (or a caller like it) set the ranks."""
    return multihost_enabled() or ("RANK" in os.environ and "WORLD_SIZE" in os.environ)


def _backend_for(device: Optional[torch.device]) -> str:
    return "nccl" if device is not None and torch.device(device).type == "cuda" else "gloo"


def local_rank() -> int:
    """This process's rank on its host: torchrun's ``LOCAL_RANK``, else the
    global rank modulo the visible cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    n = max(torch.cuda.device_count(), 1)
    return (dist.get_rank() if dist.is_initialized() else 0) % n


def maybe_initialize_distributed(device=None) -> bool:
    """Idempotent, env-gated ``init_process_group`` from the environment
    (``launched``): the JAX gate's variables are mapped onto torch's, and a
    CUDA run takes ``cuda:LOCAL_RANK`` and NCCL, a CPU run gloo. Returns
    True iff a process group is up; a run with no launcher returns False
    and touches nothing."""
    if dist.is_initialized():
        return True
    if not launched():
        return False
    env = os.environ
    coord = env.get("RECOMBINER_TPU_COORDINATOR")
    if coord:
        host, _, port = coord.rpartition(":")
        env.setdefault("MASTER_ADDR", host)
        env.setdefault("MASTER_PORT", port)
    for jax_name, torch_name in (("RECOMBINER_TPU_NUM_PROCESSES", "WORLD_SIZE"),
                                 ("RECOMBINER_TPU_PROCESS_ID", "RANK")):
        if env.get(jax_name):
            env.setdefault(torch_name, env[jax_name])
    backend = _backend_for(device)
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """Rank 0 writes the artifacts, bitstreams, CSVs and snapshots; the
    others skip."""
    return process_index() == 0


def rank_device(device) -> torch.device:
    """The device this rank computes on: a CUDA device becomes the card the
    group set for this rank (``cuda:LOCAL_RANK``, or the one card that
    several ranks share), the CPU stays the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def visible_devices(device) -> int:
    """How many ranks ``--n_devices`` may ask for: the visible cards, or on
    the CPU one rank per core."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def requested_world(n_devices: Optional[int], device) -> int:
    """The world size ``--n_devices`` asks for: None is every visible card
    (one process on the CPU), as ``make_mesh(None)`` takes every device; a
    count above the visible ones raises, as ``mesh.py:24-29`` does."""
    visible = visible_devices(device)
    if n_devices is None:
        return visible if torch.device(device).type == "cuda" else 1
    if n_devices < 1 or n_devices > visible:
        raise ValueError(f"--n_devices {n_devices} requested but only {visible} devices are "
                         "visible")
    return int(n_devices)


# ------------------------------------------------------------------ spawn


def _rank_main(rank: int, world: int, init_method: str, backend: str, cuda: str,
               timeout_s: float, fn: Callable, args: tuple) -> None:
    """One spawned rank: its environment (so that ``is_primary`` and a CLI
    see a launched run), its card, the group, ``fn(rank, *args)``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    if cuda == "own":
        torch.cuda.set_device(rank)
    elif cuda == "shared":
        torch.cuda.set_device(0)
    else:  # CPU ranks share the cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (), *, backend: str = "gloo",
          cuda: str = "none", timeout_s: Optional[float] = None) -> None:
    """Run ``fn(rank, *args)`` in ``world`` fresh processes (start method
    ``spawn``: never a fork of a process that may hold a CUDA context), each
    in a process group of ``backend`` that meets through a file in a new
    temporary directory. ``cuda``: 'own' puts rank r on ``cuda:r``,
    'shared' every rank on ``cuda:0`` (NCCL refuses that: use gloo),
    'none' the CPU. ``fn`` must be importable by name (a module-level
    function). A rank that raises or dies ends the others and raises here;
    past ``timeout_s`` (None: no limit) every rank is ended and
    ``TimeoutError`` raised, and no collective waits longer than that."""
    tmp = tempfile.mkdtemp(prefix="rendezvous_")
    try:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(world, f"file://{os.path.join(tmp, 'store')}", backend, cuda,
                              timeout_s or COLLECTIVE_TIMEOUT_S, fn, tuple(args)),
            nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while not ctx.join(timeout=5.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{world} ranks did not finish in {timeout_s} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run_cli(rank: int, module: str, argv: Sequence[str]) -> None:
    importlib.import_module(module).main(list(argv))


def spawn_if_needed(module: str, argv: Optional[Sequence[str]], n_devices: Optional[int],
                    device) -> bool:
    """The CLIs' launch step. Under a launcher (or in a spawned rank) the
    group is started, or already up, and must have the size
    ``--n_devices`` asks for; without one, a world size above 1 spawns that
    many ranks, each running ``module``'s ``main(argv)`` (one card each
    and NCCL, or with ``--device cpu`` gloo), and returns True when they
    are done: the caller returns. False: run here."""
    import sys

    dev = torch.device(device)
    if maybe_initialize_distributed(dev):
        world = dist.get_world_size()
        if n_devices is not None and n_devices != world:
            raise ValueError(f"--n_devices {n_devices} in a group of {world} processes")
        return False
    world = requested_world(n_devices, dev)
    if world == 1:
        return False
    argv = list(sys.argv[1:] if argv is None else argv)
    spawn(_run_cli, world, (module, argv), backend=_backend_for(dev),
          cuda="own" if dev.type == "cuda" else "none")
    return True


# --------------------------------------------------------------- host copies


def fetch_global(x, part=None) -> np.ndarray:
    """Host copy of a possibly row-sharded tensor: this rank's rows when
    ``part`` is None or replicated, else every rank's rows in rank order
    (``mesh.gather_rows``, which takes shards of unequal size). Every rank
    of a sharded group must call it."""
    from recombiner_tpu_torch.parallel.mesh import gather_rows

    t = torch.as_tensor(x)
    return gather_rows(t, part).detach().cpu().numpy()


def shard_rows_global(x, part, device=None) -> torch.Tensor:
    """HOST-LOCAL rows as this rank's shard: each process loaded only its
    own block of ``part`` (no rank holds the whole set), checked against
    the block's size and moved to ``device``."""
    t = torch.as_tensor(np.asarray(x), device=device)
    if part is not None and part.sharded:
        n_global = part.global_rows(t.shape[0])
        want = part.block(n_global)
        if t.shape[0] != want.stop - want.start:
            raise ValueError(f"{t.shape[0]} local rows; rank {part.mesh.rank}'s block of "
                             f"{n_global} holds {want.stop - want.start}")
    return t
