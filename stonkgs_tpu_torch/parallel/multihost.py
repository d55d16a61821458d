"""Multi-process training of the port: the process group and the input rows.

The port of the JAX package's ``stonkgs_tpu/parallel/multihost.py``.  A
JAX process drives every device of its host; torch runs one process per
card (``torchrun --nproc_per_node=N``), so a rank here is one card, or one
share of a card:

* :func:`initialize` starts the process group from torchrun's variables
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
  ``MASTER_ADDR``, ``MASTER_PORT``); with a single process it does
  nothing, as the JAX version does.  The backend follows from where the
  ranks sit: NCCL where every rank of the host has a card of its own,
  gloo on the CPU or where ranks share a card (NCCL refuses two ranks on
  one card);
* :func:`host_local_slice`, :func:`global_batch` and
  :func:`multihost_data_iterator` give each rank its rows of every
  global batch: every process draws the same permutation from the seed
  and keeps its share;
* :func:`launch` spawns ranks on this host with those variables set, for
  tests, the dry run and the smoke test.
"""

from __future__ import annotations

import logging
import os
import socket
import traceback
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from stonkgs_tpu_torch.parallel.mesh import Mesh

logger = logging.getLogger(__name__)


def _int_env(name: str) -> Optional[int]:
    v = os.getenv(name)
    return int(v) if v else None


def default_backend(local_world: int) -> str:
    """NCCL when this host has a card for each of its ``local_world``
    ranks, else gloo."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def local_device() -> torch.device:
    """This rank's device: card ``LOCAL_RANK`` (modulo the cards visible,
    so ranks that outnumber the cards share them), or the CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    return torch.device("cuda", (_int_env("LOCAL_RANK") or 0) % torch.cuda.device_count())


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None) -> bool:
    """Start the default process group (idempotent; a no-op for one process).

    The arguments default to torchrun's variables; ``init_method``
    defaults to ``tcp://MASTER_ADDR:MASTER_PORT``.  Returns whether a
    process group of several ranks (or one given explicitly) is up."""
    if dist.is_initialized():
        return True
    world_size = world_size if world_size is not None else _int_env("WORLD_SIZE")
    rank = rank if rank is not None else _int_env("RANK")
    if init_method is None and world_size in (None, 1):
        logger.info("single-process run; no process group")
        return False
    world_size = world_size or 1
    rank = rank or 0
    local_world = _int_env("LOCAL_WORLD_SIZE") or world_size
    backend = backend or default_backend(local_world)
    if backend == "nccl":
        torch.cuda.set_device(local_device())
    if init_method is None:
        init_method = (f"tcp://{os.getenv('MASTER_ADDR', 'localhost')}:"
                       f"{os.environ['MASTER_PORT']}")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    logger.info("initialized rank %d/%d (%s)", rank, world_size, backend)
    return True


def host_local_slice(n: int, mesh: Optional[Mesh] = None) -> slice:
    """This rank's contiguous share of a length-``n`` global batch: by its
    data index on a mesh (ranks of one data index share rows), else by its
    rank in the process group."""
    if mesh is not None:
        p, k = mesh.n_data, mesh.data_index
    elif dist.is_initialized():
        p, k = dist.get_world_size(), dist.get_rank()
    else:
        p, k = 1, 0
    if n % p:
        raise ValueError(f"global batch {n} is not divisible by {p} shares")
    per = n // p
    return slice(k * per, (k + 1) * per)


def global_batch(features: Dict[str, np.ndarray], mesh: Optional[Mesh] = None,
                 device=None) -> Dict[str, torch.Tensor]:
    """This rank's rows (already cut, ``features`` holds the rank's own) as
    tensors on its device: the rank's part of the global batch, which the
    train step's collectives join (the JAX version assembles a global
    array instead)."""
    device = local_device() if device is None else device
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in features.items()}


def multihost_data_iterator(features: Dict[str, np.ndarray], global_batch_size: int,
                            mesh: Optional[Mesh] = None, *, seed: int = 0, device=None):
    """Epoch iterator of this rank's rows of every global batch: every
    process draws the same permutation (seeded on the host) and keeps its
    share."""
    n = len(features["input_ids"])
    rng = np.random.default_rng(seed)
    local = host_local_slice(global_batch_size, mesh)
    while True:
        perm = rng.permutation(n)
        for i in range(0, n - global_batch_size + 1, global_batch_size):
            idx = perm[i: i + global_batch_size][local]
            yield global_batch({k: v[idx] for k, v in features.items()}, mesh, device)


# ---------------------------------------------------------------------------
# spawning ranks on this host
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A TCP port on localhost that was free when asked (bound to 0)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, n_ranks: int, port: int, fn: Callable, args: Sequence,
               results, backend: Optional[str], threads: Optional[int]) -> None:
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(n_ranks),
                       "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(n_ranks),
                       "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)})
    if threads:
        torch.set_num_threads(threads)
    try:
        initialize(backend=backend)
        out = fn(*args)
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 -- handed to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, n_ranks: int, args: Sequence = (), *, backend: Optional[str] = None,
           threads: Optional[int] = None, timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``n_ranks`` spawned ranks of this host, each
    with torchrun's variables set and :func:`initialize` called; returns
    every rank's result, by rank.  ``fn`` and its results must pickle.

    Raises with the first failing rank's traceback; every process is
    ended before this returns."""
    import queue

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n_ranks, port, fn, tuple(args), results, backend, threads),
                         daemon=True)
             for r in range(n_ranks)]
    for p in procs:
        p.start()
    out, errors = {}, []
    try:
        while len(out) + len(errors) < n_ranks:
            try:
                rank, ok, value = results.get(timeout=timeout)
            except queue.Empty:
                raise RuntimeError(f"launch: no result from a rank within {timeout} s")
            if ok:
                out[rank] = value
            else:
                errors.append((rank, value))
                break
    finally:
        if errors:
            for p in procs:
                p.kill()
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        rank, tb = errors[0]
        raise RuntimeError(f"rank {rank} of {n_ranks} failed:\n{tb}")
    return [out[r] for r in range(n_ranks)]
