"""Sharded placement scoring and EM over a mesh of shards (counterpart of
panmap_tpu/parallel/mesh.py).

The JAX package builds a 1-D ``jax.sharding.Mesh`` and runs its programs
under ``shard_map``: index rows (placement) or reads (the EM) split over
the devices, per-shard partial sums combined with a ``psum``.  Here a
``Mesh`` is a list of this process's shards, one ``torch.device`` each,
and the process group of the run.  A program computes one partial a shard,
and ``reduce_partials`` is the psum: the shards' partials summed in shard
order on the first shard's device, then ``all_reduce`` over the ranks.
Everything column-shaped (node sums, EM proportions) stays whole on every
rank.  The sharded EM (make_sharded_em_fn / make_sharded_em_full_fn) is
meta.em.squarem(mesh=...), its three sums over reads reduced here.

Shards may repeat a device: two shards on one card run the sharded
programs in one process on one card, which is how the tests (CPU shards)
and chip_smoke.py (two shards on cuda:0) hold a sharded result against the
unsharded one.  The CLI builds meshes of distinct cards only
(``local_devices``).

The JAX package's make_sharded_sketch_fn (the device read sketch) has no
twin yet: the port sketches reads on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import dist as pdist


@dataclass
class Mesh:
    """This process's shards and the group the partials reduce over."""

    devices: list  # torch.device per local shard (repeats allowed)
    group: object = None  # torch.distributed process group; None: one process
    local: bool = False  # reduce within this process only (batch shards)

    @property
    def nprocs(self) -> int:
        if self.group is None or self.local:
            return 1
        import torch.distributed as dist

        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        if self.group is None or self.local:
            return 0
        import torch.distributed as dist

        return dist.get_rank(self.group)

    @property
    def size(self) -> int:
        """Shards over every rank of the reduction."""
        return len(self.devices) * self.nprocs

    def own_shards(self, n_rows: int):
        """[(device, start, stop)] of this process's shards of ``n_rows``
        rows split into ``size`` equal contiguous parts (n_rows must be a
        multiple of size): rank r holds parts r*k .. r*k + k - 1."""
        per = n_rows // self.size
        if per * self.size != n_rows:
            raise ValueError(f"{n_rows} rows do not split into {self.size} "
                             f"shards")
        first = self.rank * len(self.devices)
        return [(d, (first + i) * per, (first + i + 1) * per)
                for i, d in enumerate(self.devices)]


def local_devices() -> list:
    """The cards a mesh of this process may use: every CUDA card in one
    process, the rank's own card (rank % device_count) in a process
    group."""
    n = torch.cuda.device_count()
    if pdist.process_rank_safe()[1] > 1:
        return [torch.device("cuda", pdist.rank_card_index())] if n else []
    return [torch.device("cuda", i) for i in range(n)]


def global_device_count(local: bool = False) -> int:
    _, world = pdist.process_rank_safe()
    return len(local_devices()) * (1 if local else world)


def make_mesh(n_devices: int | None = None, local: bool = False,
              devices: list | None = None) -> Mesh:
    """A mesh over ``n_devices`` shards of the run (None: all of them),
    spread over every rank of the process group; ``local=True`` keeps the
    reduction in this process, as the manifest-sharded batch mode needs
    (each rank places other samples).  ``devices``: this process's shards
    given explicitly (tests, chip_smoke.py), repeats allowed."""
    world = pdist.process_rank_safe()[1]
    group = None
    if world > 1:
        import torch.distributed as dist

        group = dist.group.WORLD
    if devices is None:
        devices = local_devices()
        if n_devices is not None:
            per_rank = n_devices if local or group is None else max(
                1, n_devices // world)
            devices = devices[:per_rank]
    if not devices:
        raise RuntimeError("make_mesh: no device for a shard")
    return Mesh(devices=[torch.device(d) for d in devices], group=group,
                local=local)


def pad_rows(arr: np.ndarray, multiple: int, fill=0):
    n = len(arr)
    pad = (-n) % multiple
    if pad == 0:
        return arr
    return np.concatenate([arr, np.full(pad, fill, dtype=arr.dtype)])


def reduce_partials(parts: list, mesh: Mesh):
    """The psum: the shards' partials summed in shard order on the first
    shard's device, then summed over the ranks (gloo all_reduce) unless
    the mesh is local.  Every rank gets the same tensor."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p.to(out.device)
    if mesh.nprocs > 1:
        import torch.distributed as dist

        out = out.contiguous()
        dist.all_reduce(out.view(-1), group=mesh.group)
    return out


def sharded_score(mesh: Mesh, shards: list, euler_in, euler_out, read_ids,
                  read_logc, n_nodes: int):
    """Placement accumulators [N,6] with the index rows sharded (twin of
    make_sharded_score_fn): each shard joins its rows to the sorted read
    table (``read_ids`` int64, ``read_logc`` float32), sums its row deltas
    per node, the partials reduce over the mesh and the Euler-tour prefix
    runs once on the first shard's device.  ``shards``: this process's
    (row_id, row_parent, row_child, row_node) per mesh device."""
    from ..place.metrics import euler_prefix, row_node_sums

    parts = []
    for rid, rp, rc, rn in shards:
        ids = read_ids.to(rid.device)
        if len(ids):
            posc = torch.searchsorted(ids, rid).clamp_max(len(ids) - 1)
            found = ids[posc] == rid
            lrc = torch.where(found, read_logc.to(rid.device)[posc], 0.0)
        else:
            found = torch.zeros(rid.shape, dtype=torch.bool,
                                device=rid.device)
            lrc = torch.zeros(rid.shape, dtype=read_logc.dtype,
                              device=rid.device)
        parts.append(row_node_sums(lrc, rp, rc, found, rn, n_nodes))
    node_sums = reduce_partials(parts, mesh)
    return euler_prefix(node_sums, euler_in.to(node_sums.device),
                        euler_out.to(node_sums.device), n_nodes)


def split_rows(mesh: Mesh, *arrays):
    """This process's shards of row-aligned tensors (rows a multiple of
    mesh.size), each moved to its shard's device: [(part of each array)]
    per shard."""
    return [tuple(a[lo:hi].to(d) for a in arrays)
            for d, lo, hi in mesh.own_shards(arrays[0].shape[0])]

