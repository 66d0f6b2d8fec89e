"""Native index container (.ptidx): flat numpy arrays, mmap-friendly.

Replaces the reference's capnp+ZSTD LiteIndex container
(src/index_single_mode.cpp:1560-1636) with a plain layout designed for
np.load(mmap_mode='r') / direct jnp.asarray: a .npz when compressed, or a .npy
directory-free single-file bundle via savez (uncompressed) for mmap.
The parameter header is embedded so cache validation never touches the payload.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..index.builder import IndexArrays, IndexParams

FORMAT_VERSION = 4  # semantic parity with panmapUtils::INDEX_FORMAT_VERSION


def save_index(path: str, idx: IndexArrays, compressed: bool = False):
    header = {
        "format_version": FORMAT_VERSION,
        "k": idx.params.k,
        "s": idx.params.s,
        "t": idx.params.t,
        "l": idx.params.l,
        "open": idx.params.open,
        "hpc": idx.params.hpc,
        "flank_mask_bp": idx.params.flank_mask_bp,
        "impute_amb": idx.params.impute_amb,
        "extent_guard": idx.params.extent_guard,
    }
    arrays = dict(
        header=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
        node_ids=np.frombuffer("\n".join(idx.node_ids).encode(), dtype=np.uint8),
        parent_index=idx.parent_index,
        identical_to_parent=idx.identical_to_parent,
        block_ranges=idx.block_ranges,
        seed_hashes=idx.seed_hashes,
        parent_counts=idx.parent_counts,
        child_counts=idx.child_counts,
        node_offsets=idx.node_offsets,
        substitution_matrix=idx.substitution_matrix,
    )
    # atomic publish: write to a process-unique temp in the same directory,
    # then rename over the destination — concurrent readers (multi-host batch
    # mode shares the cache path on a shared filesystem) never see a partial
    # file, and concurrent writers are last-writer-wins with identical content
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    try:
        if compressed:
            np.savez_compressed(tmp, **arrays)
        else:
            np.savez(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def read_index_params(path: str) -> dict:
    with np.load(path) as z:
        return json.loads(bytes(z["header"]).decode())


def load_index(path: str) -> IndexArrays:
    z = np.load(path)
    header = json.loads(bytes(z["header"]).decode())
    if header.get("format_version") != FORMAT_VERSION:
        raise RuntimeError(
            f"Index format version {header.get('format_version')} is incompatible "
            f"(expects {FORMAT_VERSION}). Rebuild the index."
        )
    params = IndexParams(
        k=header["k"], s=header["s"], t=header["t"], l=header["l"],
        open=header["open"], hpc=header["hpc"], flank_mask_bp=header["flank_mask_bp"],
        impute_amb=header.get("impute_amb", False),
        extent_guard=header.get("extent_guard", False),
    )
    return IndexArrays(
        params=params,
        node_ids=bytes(z["node_ids"]).decode().split("\n"),
        parent_index=z["parent_index"],
        identical_to_parent=z["identical_to_parent"],
        block_ranges=z["block_ranges"],
        seed_hashes=z["seed_hashes"],
        parent_counts=z["parent_counts"],
        child_counts=z["child_counts"],
        node_offsets=z["node_offsets"],
        substitution_matrix=z["substitution_matrix"],
    )
