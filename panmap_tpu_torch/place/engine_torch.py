"""Device-resident placement index (counterpart of
panmap_tpu/place/engine_tpu.py:35-154).

Rows are re-mapped once per index to dense int ids on the host, so the
row<->read join is an integer gather on the device.  The per-node reduction
structures (BlockSegments for the full row stream, CscIndex for the sparse
found-rows path) and the Euler tour of the DFS-preorder tree are built on
the host and uploaded once.

Under a mesh (parallel/mesh.py) the rows are padded to a multiple of the
mesh's size with inert rows and split into equal shards; this process
uploads its own shards, one to each of its mesh devices, and builds
neither reduction structure (the mesh path sums each shard per node).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..index.builder import IndexArrays
from ..utils.fastnp import unique_inverse
from . import metrics


@dataclass
class DeviceIndex:
    """Host-prepared, device-resident index tensors."""

    unique_hashes: np.ndarray  # u64[U] sorted (host only, for query mapping)
    row_id: torch.Tensor | None  # i64[T] index into unique_hashes
    row_parent: torch.Tensor | None  # i16[T] parent seed counts
    row_child: torch.Tensor | None  # i16[T] child seed counts
    euler_in: torch.Tensor  # i64[N]
    euler_out: torch.Tensor  # i64[N]
    n_nodes: int
    root_rows: tuple  # (start, end) row range of the root node
    blk: metrics.BlockSegments | None  # static blocked per-node reduction
    csc: metrics.CscIndex | None  # rows grouped by unique hash (sparse path)
    # host copies of the root node's row ids / child counts (the f64
    # weighted-containment denominator of the sparse path)
    root_rid_np: np.ndarray
    root_child_np: np.ndarray
    device: torch.device
    # under a mesh: this process's (row_id, row_parent, row_child, row_node)
    # per mesh device; the four whole-row fields above are then None
    shards: list | None = None


def euler_tour(parent_index: np.ndarray):
    """(euler_in, euler_out) slots of a DFS-preorder tree given its parent
    array; raises when the numbering is not a preorder (the Euler-tour
    prefix is only valid when the subtree of i is [i, i + size[i]))."""
    n_nodes = len(parent_index)
    parent = parent_index.astype(np.int64)
    sizes = np.ones(n_nodes, dtype=np.int64)
    for i in range(n_nodes - 1, 0, -1):
        sizes[parent[i]] += sizes[i]
    # preorder: euler_in[i] = i + (nodes closed before i) = 2i - depth[i]
    depth = np.zeros(n_nodes, dtype=np.int64)
    for i in range(1, n_nodes):
        depth[i] = depth[parent[i]] + 1
    euler_in = 2 * np.arange(n_nodes, dtype=np.int64) - depth
    euler_out = euler_in + 2 * sizes - 1
    if n_nodes > 1:
        ii = np.arange(1, n_nodes)
        pp = parent[ii]
        if not np.all((pp < ii) & (ii < pp + sizes[pp])):
            raise ValueError("index parent_index is not in DFS preorder")
    return euler_in, euler_out


def prepare_device_index(idx: IndexArrays, device, mesh=None) -> DeviceIndex:
    """Host -> device index preparation on ``device`` (may be the CPU for
    the parity tests).  With ``mesh``: the row tensors padded to a multiple
    of mesh.size with inert rows (P == C == 0: every delta is 0; row_node
    n_nodes - 1, so it stays sorted) and split into mesh.size shards, this
    process's on its mesh devices; the tree tensors on ``device``."""
    device = torch.device(device)
    uniq, row_id = unique_inverse(idx.seed_hashes)
    n_nodes = len(idx.node_offsets) - 1
    offs = idx.node_offsets.astype(np.int64)
    row_node = np.repeat(np.arange(n_nodes, dtype=np.int32), np.diff(offs))
    parent = idx.parent_index.astype(np.int64)
    euler_in, euler_out = euler_tour(parent)
    rid = row_id.astype(np.int32)
    a, b = int(offs[0]), int(offs[1])

    def put(x, dt):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device=device,
                                                              dtype=dt)

    rp = idx.parent_counts.astype(np.int16)
    rc = idx.child_counts.astype(np.int16)
    if mesh is None:
        rows = dict(
            # counts stay i16 (their storage dtype); scorers cast to f32,
            # exact
            row_id=put(rid, torch.int64), row_parent=put(rp, torch.int16),
            row_child=put(rc, torch.int16),
            blk=metrics.block_segments(row_node, n_nodes, device),
            csc=metrics.csc_index(rid, idx.parent_counts, idx.child_counts,
                                  row_node, len(uniq), n_nodes, parent,
                                  device))
    else:
        from ..parallel.mesh import pad_rows, split_rows

        n = mesh.size
        rows = dict.fromkeys(("row_id", "row_parent", "row_child", "blk",
                              "csc"))
        rows["shards"] = split_rows(
            mesh, torch.from_numpy(pad_rows(rid, n).astype(np.int64)),
            torch.from_numpy(pad_rows(rp, n)),
            torch.from_numpy(pad_rows(rc, n)),
            torch.from_numpy(pad_rows(row_node, n, n_nodes - 1)
                             .astype(np.int64)))
    return DeviceIndex(
        unique_hashes=uniq,
        euler_in=put(euler_in, torch.int64),
        euler_out=put(euler_out, torch.int64),
        n_nodes=n_nodes,
        root_rows=(a, b),
        root_rid_np=rid[a:b].copy(),
        root_child_np=idx.child_counts[a:b].astype(np.float64),
        device=device,
        **rows,
    )
