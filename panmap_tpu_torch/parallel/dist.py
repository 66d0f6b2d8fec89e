"""Multi-process runs over torch.distributed (counterpart of
panmap_tpu/parallel/dist.py).

The JAX package runs one process per host against a jax.distributed
coordinator, after which its device list spans every host.  Here each
process is a rank of a torch.distributed process group and drives one card,
``cuda:(rank % device_count)``: a host with several cards runs one rank per
card, as torchrun does.  The mesh programs (parallel/mesh.py) combine their
partial sums across the ranks with ``all_reduce``.

The backend is gloo: ranks that share one card (the way the tests and
chip_smoke.py run two ranks on one machine) cannot use NCCL, and gloo takes
CUDA tensors for ``all_reduce`` and ``broadcast``.  What crosses the ranks
is small: per placement query the [nodes, 6] float32 node sums, per EM step
a few vectors of the candidates' width.

Rendezvous: ``--dist-coordinator HOST:PORT`` becomes ``tcp://HOST:PORT``; an
address with a scheme (``file:///path``) is taken as it is.  Without the
flags the torchrun environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)
is honoured, as the JAX package honours JAX_COORDINATOR_ADDRESS.
"""

from __future__ import annotations

import os

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _env_announced() -> bool:
    return all(os.environ.get(k) for k in _ENV)


def maybe_initialize(coordinator: str = "", num_processes: int = 0,
                     process_id: int = -1, log=print) -> bool:
    """Create the gloo process group when the flags or the torchrun
    environment ask for one.  Returns True when this process is a rank of
    a group.  Idempotent: repeat calls return True.  With neither flags nor
    environment it returns False and leaves torch.distributed alone.  A
    failed rendezvous raises (torch's own error)."""
    if getattr(maybe_initialize, "_done", False):
        return True
    flags = (bool(coordinator), num_processes > 0, process_id >= 0)
    if all(flags):
        init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        kw = dict(init_method=init, world_size=num_processes,
                  rank=process_id)
    elif _env_announced():
        init, kw = "env://", dict(init_method="env://")
    else:
        if any(flags):
            log("[dist] --dist-coordinator, --dist-nprocs and --dist-pid go "
                "together; running as one process")
        return False
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", **kw)
    maybe_initialize._done = True
    rank, world = dist.get_rank(), dist.get_world_size()
    # device_count reads NVML: no CUDA context before batch mode forks
    n_cards = torch.cuda.device_count()
    card = f"cuda:{rank % n_cards}" if n_cards else "no CUDA card"
    log(f"[dist] process {rank}/{world} via {init} (gloo): {card}")
    return True


def shutdown():
    """Destroy the process group maybe_initialize created (end of the
    CLI)."""
    if getattr(maybe_initialize, "_done", False):
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        maybe_initialize._done = False


def process_rank_safe() -> tuple:
    """(rank, world size), (0, 1) outside a process group.  Reads
    torch.distributed.is_initialized() only: it never creates a backend
    (forked host workers must not)."""
    import sys

    dist = sys.modules.get("torch.distributed")
    if dist is None or not dist.is_available() or not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def rank_card_index() -> int:
    """This rank's CUDA card: rank % device_count (0 in one process)."""
    import torch

    rank, world = process_rank_safe()
    n = torch.cuda.device_count()
    return rank % n if world > 1 and n else 0


def process_read_shard(n_items: int, pid: int | None = None,
                       nprocs: int | None = None) -> slice:
    """This process's contiguous shard of a host-side work list (a batch
    manifest): ceil(n / nprocs) items a rank, the last rank takes what is
    left.  Identity slice in one process.  ``pid`` and ``nprocs`` together
    name another rank's shard; by default the live rank is used."""
    if (pid is None) != (nprocs is None):
        raise ValueError("process_read_shard: give pid and nprocs together")
    if pid is None:
        pid, nprocs = process_rank_safe()
    pid, nprocs = int(pid), int(nprocs)
    if nprocs < 1 or not 0 <= pid < nprocs:
        raise ValueError(f"process_read_shard: pid {pid} outside "
                         f"[0, {nprocs})")
    if nprocs == 1:
        return slice(0, n_items)
    per = (n_items + nprocs - 1) // nprocs
    return slice(pid * per, min((pid + 1) * per, n_items))
