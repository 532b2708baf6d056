"""Static-shape relations.

A :class:`Relation` is the stand-in for an RDD of key/value pairs: dense
``keys``/``values`` tensors plus a ``valid`` mask ("fewer rows" is expressed
by masking, and every pipeline stage is a dense pass).

Keys are uint32 values carried in int64: PyTorch has no ``>>`` or ``%`` on
``torch.uint32``, and a raw cast to int32 would sort keys >= 2^31 first.
:func:`sort_by_key` sorts on int32 all the same, through the offset map
``key - 2^31``, which keeps the keys' unsigned order in 4 bytes, and sorts
only the valid rows: a stable partition puts them first and the invalid
rows after them, each in row order.  Values are float32 and ``valid`` is
bool.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.hashing import MASK


class Relation(NamedTuple):
    """A key/value relation with a validity mask."""

    keys: torch.Tensor    # int64 [N], values in [0, 2^32)
    values: torch.Tensor  # float32 [N]
    valid: torch.Tensor   # bool [N]

    @property
    def capacity(self) -> int:
        return self.keys.shape[-1]

    def count(self) -> torch.Tensor:
        return self.valid.sum(-1)

    def masked_keys(self, fill: int = 0xFFFFFFFF) -> torch.Tensor:
        """Keys with invalid slots replaced by ``fill`` (sorts to the end)."""
        return torch.where(self.valid, self.keys, fill)


def _keys_tensor(keys, device) -> torch.Tensor:
    if isinstance(keys, torch.Tensor):
        return keys.to(device=device, dtype=torch.int64) & MASK
    arr = np.asarray(keys)
    if arr.dtype.kind in "iu":
        arr = arr.astype(np.int64) & MASK
    return torch.as_tensor(np.ascontiguousarray(arr, np.int64), device=device)


def relation(keys, values=None, valid=None, device="cuda") -> Relation:
    """Build a Relation from array-likes on ``device``, filling defaults."""
    keys = _keys_tensor(keys, device)
    if values is None:
        values = torch.zeros(keys.shape, dtype=torch.float32, device=device)
    values = torch.as_tensor(values, dtype=torch.float32, device=device)
    if valid is None:
        valid = torch.ones(keys.shape, dtype=torch.bool, device=device)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=device)
    if not (keys.shape == values.shape == valid.shape and keys.dim() == 1):
        raise ValueError(f"relation: shapes {tuple(keys.shape)}, "
                         f"{tuple(values.shape)}, {tuple(valid.shape)}")
    return Relation(keys, values, valid)


def from_numpy(keys: np.ndarray, values: np.ndarray, valid: np.ndarray,
               device="cuda") -> Relation:
    """A Relation from host arrays: uint32 keys, float32 values, bool valid.

    This is how state crosses from another implementation of the operator:
    its relation's three arrays, as numpy, come in here unchanged.
    """
    return relation(np.asarray(keys, np.uint32), np.asarray(values, np.float32),
                    np.asarray(valid, bool), device=device)


def pad_to(rel: Relation, capacity: int) -> Relation:
    """Pad a relation with invalid rows up to ``capacity``."""
    n = rel.capacity
    if n == capacity:
        return rel
    if n > capacity:
        raise ValueError(f"cannot shrink relation {n} -> {capacity}")
    pad = capacity - n
    return Relation(
        torch.cat([rel.keys, rel.keys.new_zeros(pad)]),
        torch.cat([rel.values, rel.values.new_zeros(pad)]),
        torch.cat([rel.valid, rel.valid.new_zeros(pad)]),
    )


def bucket_capacity(n: int, minimum: int = 1) -> int:
    """Round a row count up to the next power of two (shape-class bucketing).

    ``minimum`` floors the bucket (a sharded relation needs capacity
    divisible by the device count; any power of two >= k is).
    """
    return max(1 << max(int(n) - 1, 0).bit_length(), int(minimum))


def bucket_to_pow2(rel: Relation, minimum: int = 1) -> Relation:
    """Pad a relation with invalid rows up to its power-of-two bucket."""
    return pad_to(rel, bucket_capacity(rel.capacity, minimum))


def fingerprint(rel: Relation) -> str:
    """Content id of a relation's key set (keys + validity mask).

    Hashes the keys as uint32 bytes, so a relation and its copy in the JAX
    implementation share one fingerprint (and so one cached filter).
    """
    h = hashlib.sha1()
    h.update(rel.keys.cpu().numpy().astype(np.uint32).tobytes())
    h.update(np.packbits(rel.valid.cpu().numpy()).tobytes())
    return h.hexdigest()


def shard_rows(rel: Relation, num_shards: int) -> Relation:
    """Reshape ``[N]`` -> ``[num_shards, N / num_shards]``: shard ``d``'s
    contiguous block of rows is row ``d``."""
    if rel.capacity % num_shards:
        raise ValueError(f"shard_rows: {rel.capacity} rows over "
                         f"{num_shards} shards")
    return Relation(*(x.reshape(num_shards, -1) for x in rel))


def shard_to_mesh(rel: Relation, mesh, axes) -> Relation:
    """This rank's block of a relation's rows on ``mesh``.

    The rows split into contiguous blocks over the combined ``axes``,
    major first (as the JAX package's ``PartitionSpec(tuple(axes))`` splits
    them), and every rank along an axis outside ``axes`` (a ``"model"``
    axis) holds the same block.  Every rank passes the whole relation and
    keeps its block; nothing crosses ranks.
    """
    from repro_torch.core.distributed import axis_size, combined_axis_index
    k = 1
    for a in axes:
        k *= axis_size(mesh, a)
    return Relation(*(x[combined_axis_index(mesh, axes)].clone()
                      for x in shard_rows(rel, k)))


def sort_by_key(rel: Relation, live: Optional[int] = None) -> Relation:
    """Sort valid rows by key; invalid rows go last (stable).

    The order is ``torch.argsort(rel.masked_keys(), stable=True)``'s for a
    1-D relation whose valid keys are below ``2^32 - 1``, built from two
    parts: a stable partition of the rows by ``valid`` (the valid rows in
    row order, then the invalid ones in row order), and one stable sort of
    the valid rows alone on the int32 keys ``key - 2^31``.  ``live`` is the
    number of valid rows, which sizes the partition; without it the
    function reads it from the device.
    """
    if live is None:
        live = int(rel.valid.sum())
    # the live rows' sorted order fills order[:live], the dead rows the rest
    order = torch.empty_like(rel.keys)
    torch.nonzero_static(~rel.valid, size=rel.capacity - live,
                         out=order[live:].view(-1, 1))
    rows = torch.nonzero_static(rel.valid, size=live).squeeze(1)
    # each key's low 32-bit word (the first, little-endian) with its top bit
    # flipped is ``key - 2^31`` in int32
    low = rel.keys.contiguous().view(torch.int32)[::2]
    keys32 = low[rows] ^ -2**31
    torch.index_select(rows, 0, torch.argsort(keys32, stable=True),
                       out=order[:live])
    return Relation(rel.keys[order], rel.values[order], rel.valid[order])


def concatenate(rels: list[Relation]) -> Relation:
    return Relation(
        torch.cat([r.keys for r in rels]),
        torch.cat([r.values for r in rels]),
        torch.cat([r.valid for r in rels]),
    )


def to_numpy(rel: Relation):
    """(keys uint32, values float32) of the valid rows as host numpy arrays."""
    k = rel.keys.cpu().numpy().astype(np.uint32)
    v = rel.values.cpu().numpy()
    m = rel.valid.cpu().numpy()
    return k[m], v[m]
