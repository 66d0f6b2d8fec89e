"""State carried across packages: the port's index and sketch containers
from, and to, plain dicts of numpy arrays and scalars.

The port's IndexArrays / IndexParams / MetaIndexArrays / ReadSketch are its
own classes (index/builder.py, meta/index.py, place/engine.py), field for
field the JAX package's.  An object of one package is not an instance of
the other's class, so state crosses as a dict (field name -> value):
``as_dict`` reads any such container into one, the builders below make the
port's containers from one.  Nothing here imports the JAX package; a caller
that holds its objects (the parity tests) passes them through ``as_dict``
and builds that package's classes from a dict itself
(``Cls(**d)``, with ``params`` a nested dict).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .index.builder import IndexArrays, IndexParams
from .meta.index import MetaIndexArrays
from .place import metrics
from .place.engine import ReadSketch
from .place.engine_torch import DeviceIndex


def as_dict(obj) -> dict:
    """A dataclass instance or a ``__slots__`` container as {field: value}:
    nested containers become dicts, array-likes (numpy, or anything
    np.array reads, such as a device array) numpy arrays, the rest (ints,
    floats, strings, lists, dicts of scalars) is kept."""
    if dataclasses.is_dataclass(obj):
        names = [f.name for f in dataclasses.fields(obj)]
    elif hasattr(obj, "__slots__"):
        names = [n for n in obj.__slots__ if hasattr(obj, n)]
    else:
        raise TypeError(f"as_dict: {type(obj).__name__} is neither a "
                        f"dataclass nor a __slots__ container")
    return {n: _plain(getattr(obj, n)) for n in names}


def _plain(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, (np.ndarray, np.generic)) or hasattr(v, "__array__"):
        return np.array(v)
    if dataclasses.is_dataclass(v) or hasattr(v, "__slots__"):
        return as_dict(v)
    return v


def _fields(cls, d: dict, what: str) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"{what}: unknown fields {sorted(unknown)}")
    return d


def index_params(d: dict) -> IndexParams:
    return IndexParams(**_fields(IndexParams, d, "index_params"))


def index_arrays(d: dict) -> IndexArrays:
    """The port's IndexArrays from a dict (``params`` a dict or the port's
    IndexParams)."""
    d = dict(_fields(IndexArrays, d, "index_arrays"))
    if isinstance(d["params"], dict):
        d["params"] = index_params(d["params"])
    return IndexArrays(**d)


def meta_index_arrays(d: dict) -> MetaIndexArrays:
    d = dict(_fields(MetaIndexArrays, d, "meta_index_arrays"))
    if isinstance(d["params"], dict):
        d["params"] = index_params(d["params"])
    return MetaIndexArrays(**d)


def read_sketch(d: dict) -> ReadSketch:
    return ReadSketch(**_fields(ReadSketch, d, "read_sketch"))


def device_index(d: dict, device) -> DeviceIndex:
    """The port's DeviceIndex from the dict of a single-device index
    prepared elsewhere (the JAX package's engine_tpu.DeviceIndex read out by
    ``as_dict``): the index state carries across unchanged, which the
    parity tests use to score the same tensors in both packages.  Integer
    index arrays widen to int64 (torch's index dtype)."""
    device = torch.device(device)
    if d.get("blk") is None or d.get("csc") is None:
        raise ValueError("a mesh-sharded DeviceIndex has no blk/csc")

    def put(x, dt=None):
        t = torch.from_numpy(np.array(x))
        return t.to(device=device, dtype=dt or t.dtype)

    i64 = torch.int64
    jb, jc = d["blk"], d["csc"]
    blk = metrics.BlockSegments(
        L=int(jb["L"]), B=int(jb["B"]), pad=int(jb["pad"]),
        n_rows=int(jb["n_rows"]),
        lastp=put(jb["lastp"], i64), base=put(jb["base"], i64),
        has_base=put(jb["has_base"]), spanning=put(jb["spanning"]),
        seg_node=put(jb["seg_node"], i64), eb_blk=put(jb["eb_blk"], i64),
        q_flat=put(jb["q_flat"], i64), has_bnd=put(jb["has_bnd"]))
    csc = metrics.CscIndex(
        off=put(jc["off"]), P=put(jc["P"]), C=put(jc["C"]),
        node=put(jc["node"], i64), mag_prefix=put(jc["mag_prefix"]),
        off_np=np.array(jc["off_np"]), n_rows=int(jc["n_rows"]))
    return DeviceIndex(
        unique_hashes=np.array(d["unique_hashes"]),
        row_id=put(d["row_id"], i64),
        row_parent=put(d["row_parent"]),
        row_child=put(d["row_child"]),
        euler_in=put(d["euler_in"], i64),
        euler_out=put(d["euler_out"], i64),
        n_nodes=int(d["n_nodes"]),
        root_rows=tuple(int(x) for x in d["root_rows"]),
        blk=blk, csc=csc,
        root_rid_np=np.array(d["root_rid_np"]),
        root_child_np=np.array(d["root_child_np"]),
        device=device,
    )
