"""Distributed ApproxJoin over a ``torch.distributed`` device mesh.

The paper's Spark dataflow (Fig. 7) mapped onto collectives, one process a
rank (``launch/mesh.py``):

  stage                     Spark                       here
  ------------------------- --------------------------- ----------------------
  partition filters          Map at each worker          local bloom.build
  dataset filter             treeReduce OR to driver     all_gather + OR fold
                                                         (innermost axis first)
  join filter + broadcast    driver AND + broadcast      local AND (replicated)
  probe + discard            filter() on workers         local probe -> mask
  cogroup shuffle            hash shuffle                bucketize + all_to_all
  sampleDuringJoin           per-key edge sampling       vectorized sampler
  merge partial results      collect at driver           gather + key-sort, or
                                                         all_reduce of SumParts

Every rank calls the same per-device stage functions on its own block of
the rows (the JAX package's ``shard_map`` bodies); the collectives meet
inside them.  The stages mirror ``core/join.py``'s prepare / exact / sample
split, so the serving engine (``runtime/join_serve.py``) drives them the
way it drives the single-device stages.

Two merges:

* ``merge='gather'`` (default): per-device strata and statistics are
  all_gathered, key-sorted into the canonical single-device ``[S]`` slot
  layout and finished with the same arithmetic as ``core/join.py``: results
  equal the single-device pipeline bit for bit at any mesh size.  The
  shuffle routes every key to exactly one rank, its rows arrive in
  original row order (the receive buffer is source-major and every sort is
  stable), and the sampler keys its draws on the join key.
* ``merge='psum'``: the paper's dataflow.  Strata are rank-complete after
  the shuffle, so per-rank estimator parts add across ranks in one
  all_reduce; results agree with the single-device pipeline up to float
  reassociation.

Everything is static-shape: the shuffle uses capacity-bounded buckets, and
overflow is counted, never silent.

On the wire a key is its uint32 bit pattern in an int32 (the reference's 4
bytes), and a shuffle slot is 8 bytes, a key and a float32 value, the
model's ``TUPLE_BYTES``: an empty slot carries the key ``SENTINEL``, which
no real key takes (``core/sampling.py``), so no validity mask travels.
NCCL has no bitwise-OR reduction, so filters OR-merge by all_gather and a
fold, as in the reference.  Gloo takes host tensors: a card tensor on a
gloo group crosses through host memory, and its collective's time is that
staging's.  :data:`COMM` meters, per collective, the calls, the bytes this
rank put on the wire to the others and (when ``COMM.timed``) the seconds.
"""

from __future__ import annotations

import math
import time
from collections import Counter
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core import bloom
from repro_torch.core.budget import QueryBudget
from repro_torch.core.cost import CostModel, fraction_for_latency, sync
from repro_torch.core.estimators import (HTParts, StratumStats, SumParts,
                                         clt_avg_from, clt_count, clt_finish,
                                         clt_stdev_from, clt_sum_parts,
                                         ht_finish, ht_sum_parts,
                                         second_moment_stats)
from repro_torch.core.hashing import MASK, hash2
from repro_torch.core.join import (EXPRS, TUPLE_BYTES, _pilot_sizes, _slot,
                                   estimate_stage, exact_stage_from_sums,
                                   pad_stack)
from repro_torch.core.relation import Relation, shard_to_mesh, sort_by_key
from repro_torch.core.sampling import (SENTINEL, SampleResult, Strata,
                                       build_strata, exact_count,
                                       exact_sum_of_products,
                                       exact_sum_of_sums,
                                       per_stratum_value_sums, sample_edges)


class CommMeter:
    """This rank's collectives by name: calls, bytes put on the wire to
    the other ranks, and seconds (only while ``timed``: each collective
    then waits for the card before and after).

    The census (:meth:`census`) counts the same calls by collective kind
    (:data:`KINDS`), group size and whether the group's ranks lie in one
    node of :data:`GPUS_PER_NODE` consecutive ranks, which is what a
    roofline needs to charge each call at its link's rate
    (``launch/roofline.py``)."""

    def __init__(self):
        self.timed = False
        self.reset()

    def reset(self) -> None:
        self.calls: Counter = Counter()
        self.bytes: Counter = Counter()
        self.seconds: Counter = Counter()
        self.kind_calls: Counter = Counter()
        self.kind_bytes: Counter = Counter()

    def snapshot(self) -> dict:
        return {op: {"calls": self.calls[op], "bytes": self.bytes[op],
                     "ms": 1e3 * self.seconds[op]} for op in self.calls}

    def census(self) -> list:
        """One entry a (kind, group size, in one node): its calls and
        bytes, sorted."""
        return [{"kind": kind, "group": k, "intra_node": intra,
                 "calls": self.kind_calls[key],
                 "bytes": self.kind_bytes[key]}
                for key in sorted(self.kind_calls)
                for kind, k, intra in (key,)]


COMM = CommMeter()

# the collective kinds of the census; a ring moves, per rank, (k - 1) x the
# input of an all_gather, 2 (k - 1) / k of an all_reduce's tensor and
# (k - 1) / k of a reduce_scatter's input or an all_to_all's tensor
KINDS = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all",
         "broadcast", "scatter")
# an H100 node: 8 cards joined by NVLink; the ranks of a node are 8
# consecutive ranks of the default group
GPUS_PER_NODE = 8


class DistJoinResult(NamedTuple):
    estimate: torch.Tensor
    error_bound: torch.Tensor
    count: torch.Tensor
    dof: torch.Tensor
    # meters (the same on every rank)
    shuffled_tuple_bytes: torch.Tensor  # live tuples that crossed ranks
    filter_bytes: torch.Tensor          # filter all_gather volume (model)
    live_total: torch.Tensor
    input_total: torch.Tensor
    overlap_fraction: torch.Tensor
    bucket_overflow: torch.Tensor
    strata_overflow: torch.Tensor
    total_population: torch.Tensor
    sample_draws: torch.Tensor
    device_shuffled_bytes: torch.Tensor  # [k] per-rank sent-tuple bytes
    device_dropped: torch.Tensor         # [k] per-rank bucket-dropped tuples


def planned_bucket_cap(local_rows: int, k: int, overlap: float, *,
                       slack: float = 2.0, floor: int = 8) -> int:
    """Capacity-planned shuffle bucket size from a live-fraction estimate.

    The filter's shuffle saving only reaches the wire of a static-shape
    dataflow if the all_to_all buffers shrink with it: size the per-(source,
    dest) bucket for the *expected live* rows, ``local_rows * overlap / k``
    with ``slack``x headroom, instead of the lossless worst case
    (``local_rows``).  Small buckets get a ``3 sqrt(2 mean)`` concentration
    guard instead: keys place hash-randomly but rows arrive in per-key
    clumps, so the per-bucket load is compound-Poisson with variance ~
    ``2 mean``, and a plain multiplicative slack under-provisions exactly
    when buckets are a handful of rows.  Overflow beyond the plan is
    counted, never silent.
    """
    mean = local_rows * overlap / max(k, 1)
    guard = max((slack - 1.0) * mean, 3.0 * math.sqrt(max(2.0 * mean, 0.0)))
    return max(int(mean + guard), floor)


def axis_size(mesh, a: str) -> int:
    """Size of a named mesh axis."""
    return mesh.size(mesh.mesh_dim_names.index(a))


def combined_axis_index(mesh, axes: Sequence[str]) -> int:
    """This rank's linear index over possibly several axes (major first)."""
    idx = 0
    for a in axes:
        idx = idx * axis_size(mesh, a) + mesh.get_local_rank(a)
    return idx


def mesh_size(mesh, axes: Sequence[str]) -> int:
    k = 1
    for a in axes:
        k *= axis_size(mesh, a)
    return k


# ---------------------------------------------------------------------------
# Collectives.  Each takes the tensor where it lies and returns the result
# there; a card tensor on a gloo group crosses through host memory.  Over an
# axis of one rank each is the identity, and calls nothing.
# ---------------------------------------------------------------------------

def _wire(x: torch.Tensor, group) -> torch.Tensor:
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.cpu()
    return x.contiguous()


_GROUP_NODES: dict = {}


def _in_one_node(group) -> bool:
    """Whether ``group``'s ranks (the default group's for None) lie in one
    node of ``GPUS_PER_NODE`` consecutive ranks."""
    key = id(group)
    hit = _GROUP_NODES.get(key)
    if hit is None or hit[0] is not group:
        ranks = (range(dist.get_world_size()) if group is None
                 else dist.get_process_group_ranks(group))
        nodes = {r // GPUS_PER_NODE for r in ranks}
        hit = _GROUP_NODES[key] = (group, len(nodes) == 1)
    return hit[1]


def _metered(op: str, device, nbytes: int, body, kind: str, group):
    k = dist.get_world_size(group)
    key = (kind, k, _in_one_node(group))
    COMM.calls[op] += 1
    COMM.bytes[op] += nbytes
    COMM.kind_calls[key] += 1
    COMM.kind_bytes[key] += nbytes
    if not COMM.timed:
        return body()
    sync(device)
    t0 = time.perf_counter()
    out = body()
    sync(device)
    COMM.seconds[op] += time.perf_counter() - t0
    return out


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``[k_a, *x.shape]``: every rank's ``x`` along ``axis``, in the
    axis's index order (``launch/mesh.check_group_order``)."""
    return all_gather_group(x, mesh.get_group(axis))


def all_gather_group(x: torch.Tensor, group,
                     op: str = "all_gather") -> torch.Tensor:
    """``[k, *x.shape]``: every rank's ``x`` in the group's rank order, one
    all_gather metered under ``op``.  On gloo a bf16 tensor crosses as its
    int16 bits."""
    k = dist.get_world_size(group)
    if k == 1:
        return x[None]

    def body():
        w = _wire(x, group)
        bits = w.dtype == torch.bfloat16 and dist.get_backend(group) == "gloo"
        w = w.view(torch.int16) if bits else w
        out = [torch.empty_like(w) for _ in range(k)]
        dist.all_gather(out, w, group=group)
        out = torch.stack(out)
        return (out.view(torch.bfloat16) if bits else out).to(x.device)
    return _metered(op, x.device, x.numel() * x.element_size() * (k - 1),
                    body, "all_gather", group)


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Block ``j`` of ``x``'s dim 0 (whose size is the axis's) goes to rank
    ``j`` on ``axis``; block ``j`` of the result came from rank ``j``."""
    return all_to_all_group(x, mesh.get_group(axis))


def all_to_all_group(x: torch.Tensor, group,
                     op: str = "all_to_all") -> torch.Tensor:
    """:func:`all_to_all` over ``group``, metered under ``op``."""
    k = dist.get_world_size(group)
    if k == 1:
        return x

    def body():
        w = _wire(x, group)
        out = torch.empty_like(w)
        dist.all_to_all_single(out, w, group=group)
        return out.to(x.device)
    return _metered(op, x.device,
                    x.numel() * x.element_size() * (k - 1) // k, body,
                    "all_to_all", group)


def reduce_scatter_group(x: torch.Tensor, group, dim: int,
                         op: str = "reduce_scatter") -> torch.Tensor:
    """The sum of ``x`` over ``group``, of which this rank keeps the
    ``r``-th of ``k`` equal chunks of ``dim``, metered under ``op`` (a
    ring's bytes: each rank sends (k - 1) / k of its input).  On gloo a
    bf16 tensor crosses as float32, as in :func:`all_reduce`."""
    k = dist.get_world_size(group)
    if k == 1:
        return x
    wide = x.dtype == torch.bfloat16 and dist.get_backend(group) == "gloo"
    front = x.movedim(dim, 0)

    def body():
        w = _wire((front.float() if wide else front).contiguous(), group)
        out = torch.empty((w.shape[0] // k, *w.shape[1:]), dtype=w.dtype,
                          device=w.device)
        scatter = getattr(dist, "reduce_scatter_single", None) \
            or dist.reduce_scatter_tensor
        scatter(out, w, group=group)
        return out.to(x.device, x.dtype).movedim(0, dim)
    return _metered(op, x.device,
                    x.numel() * (4 if wide else x.element_size())
                    * (k - 1) // k, body, "reduce_scatter", group)


def gather_dim(x: torch.Tensor, group, dim: int,
               op: str = "all_gather") -> torch.Tensor:
    """The ranks' ``x`` concatenated on ``dim`` in the group's rank order
    (one all_gather; no grad)."""
    if dist.get_world_size(group) == 1:
        return x
    g = all_gather_group(x.contiguous(), group, op)           # [k, *x.shape]
    return g.movedim(0, dim).flatten(dim, dim + 1)


def exchange(x: torch.Tensor, group, split_dim: int, cat_dim: int,
             op: str = "all_to_all") -> torch.Tensor:
    """One all_to_all: chunk ``j`` of ``k`` of ``split_dim`` goes to rank
    ``j``, and the chunks received are concatenated on ``cat_dim`` in rank
    order (no grad; :func:`exchange_grad` carries one)."""
    k = dist.get_world_size(group)
    if k == 1:
        return x
    shape = list(x.shape)
    n = shape[split_dim] // k
    parts = x.unflatten(split_dim, (k, n)).movedim(split_dim, 0)
    got = all_to_all_group(parts.contiguous(), group, op)    # [k, ...]
    return got.movedim(0, cat_dim).flatten(cat_dim, cat_dim + 1)


class _Exchange(torch.autograd.Function):
    """Forward: :func:`exchange`; backward: the exchange back."""

    @staticmethod
    def forward(ctx, x, group, split_dim, cat_dim, op):
        ctx.args = (group, cat_dim, split_dim, op + "_grad")
        return exchange(x, group, split_dim, cat_dim, op)

    @staticmethod
    def backward(ctx, g):
        return exchange(g.contiguous(), *ctx.args), None, None, None, None


def exchange_grad(x: torch.Tensor, group, split_dim: int, cat_dim: int,
                  op: str = "all_to_all") -> torch.Tensor:
    """:func:`exchange` whose grad is exchanged back."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _Exchange.apply(x, group, split_dim, cat_dim, op)


def psum(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axes`` (one all_reduce an axis)."""
    for a in axes:
        x = all_reduce(x, mesh.get_group(a))
    return x


def all_reduce(x: torch.Tensor, group, op: str = "all_reduce",
               reduce=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum (or ``reduce``) of ``x`` over the ranks of ``group``, metered
    under ``op`` (a ring's bytes: each rank sends 2 (k - 1) / k of what
    goes on the wire).  On gloo a bf16 tensor crosses as float32 (gloo
    reduces no bf16), so it is summed there in float32 and rounded once."""
    k = dist.get_world_size(group)
    if k == 1:
        return x
    wide = x.dtype == torch.bfloat16 and dist.get_backend(group) == "gloo"

    def body():
        w = _wire(x.float() if wide else x, group)
        if w is x:                        # all_reduce sums in place
            w = w.clone()
        dist.all_reduce(w, op=reduce, group=group)
        return w.to(x.device, x.dtype)
    return _metered(op, x.device,
                    2 * x.numel() * (4 if wide else x.element_size())
                    * (k - 1) // k, body, "all_reduce", group)


class _ReduceFromGroup(torch.autograd.Function):
    """Forward: the sum over the group; backward: the identity."""

    @staticmethod
    def forward(ctx, x, group, op):
        return all_reduce(x, group, op)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyToGroup(torch.autograd.Function):
    """Forward: the identity; backward: the sum of the grads over the
    group."""

    @staticmethod
    def forward(ctx, x, group, op):
        ctx.group, ctx.op = group, op
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group, ctx.op), None, None


def reduce_from_group(x: torch.Tensor, group,
                      op: str = "all_reduce") -> torch.Tensor:
    """Megatron's g: the sum of the ranks' partial ``x`` (a row-parallel
    product's), whose grad every rank takes whole.  Identity without a
    group or over one rank."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _ReduceFromGroup.apply(x, group, op)


def copy_to_group(x: torch.Tensor, group,
                  op: str = "all_reduce_grad") -> torch.Tensor:
    """Megatron's f: ``x``, the same on every rank, enters a region whose
    ranks each use a part of it; its grad is the sum of theirs.  Identity
    without a group or over one rank."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group, op)


def gather_group(x: torch.Tensor, group, op: str = "all_gather"
                 ) -> torch.Tensor:
    """The ranks' ``x`` concatenated on its last dim in the group's rank
    order (``all_gather_group``; no grad)."""
    if dist.get_world_size(group) == 1:
        return x
    return torch.cat(list(all_gather_group(x, group, op)), -1)


class _GatherFromGroup(torch.autograd.Function):
    """Forward: ``gather_group``; backward: the sum of the ranks' grads of
    the whole, this rank's slice of it."""

    @staticmethod
    def forward(ctx, x, group, op):
        ctx.group, ctx.op, ctx.n = group, op, x.shape[-1]
        return gather_group(x, group, op)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.contiguous(), ctx.group, ctx.op + "_grad")
        r = dist.get_rank(ctx.group)
        return g.narrow(-1, r * ctx.n, ctx.n), None, None


def gather_from_group(x: torch.Tensor, group,
                      op: str = "all_gather") -> torch.Tensor:
    """The whole of a tensor whose last dim the group's ranks hold in equal
    slices, for a region where each rank uses all of it: its grad is the
    sum of the ranks' grads, cut to this rank's slice.  Identity without a
    group or over one rank."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _GatherFromGroup.apply(x.contiguous(), group, op)


def all_reduce_both_ways(x: torch.Tensor, group,
                         op: str = "all_reduce") -> torch.Tensor:
    """The sum over ``group`` whose backward also sums over it: a global
    statistic (the MoE load-balance loss's) that every rank puts into its
    own loss, whose grads the ranks then average."""
    return copy_to_group(reduce_from_group(x, group, op), group, op + "_grad")


class _GatherSeq(torch.autograd.Function):
    """Forward: the ranks' chunks of ``dim`` concatenated (all_gather);
    backward: the sum of the ranks' grads of the whole, this rank's chunk
    of it (reduce_scatter)."""

    @staticmethod
    def forward(ctx, x, group, dim, op):
        ctx.group, ctx.dim, ctx.op = group, dim, op
        return gather_dim(x, group, dim, op)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter_group(g, ctx.group, ctx.dim,
                                     "reduce_scatter_seq_grad"),
                None, None, None)


class _ScatterSeq(torch.autograd.Function):
    """Forward: the sum over the group, this rank's chunk of ``dim``
    (reduce_scatter); backward: the ranks' grads of their chunks
    concatenated (all_gather)."""

    @staticmethod
    def forward(ctx, x, group, dim, op):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter_group(x, group, dim, op)

    @staticmethod
    def backward(ctx, g):
        return (gather_dim(g, ctx.group, ctx.dim, "all_gather_seq_grad"),
                None, None, None)


def gather_seq(x: torch.Tensor, group, dim: int = 1,
               op: str = "all_gather_seq") -> torch.Tensor:
    """Megatron's f under sequence parallelism: the whole sequence from
    the ranks' chunks of ``dim`` (one all_gather), whose grad is the sum of
    the ranks' grads cut back to this rank's chunk (one reduce_scatter).
    Identity without a group or over one rank."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _GatherSeq.apply(x, group, dim, op)


def scatter_seq(x: torch.Tensor, group, dim: int = 1,
                op: str = "reduce_scatter_seq") -> torch.Tensor:
    """Megatron's g under sequence parallelism: the sum of the ranks'
    partial ``x`` (a row-parallel product's), of which this rank keeps its
    chunk of ``dim`` (one reduce_scatter); its grad is the ranks' chunks'
    grads put together (one all_gather).  Identity without a group or over
    one rank."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _ScatterSeq.apply(x, group, dim, op)


def _to_wire32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> its bits, bool -> 0/1, int64 (uint32 values) -> the uint32
    bit pattern: one int32 per element."""
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    if x.dtype == torch.bool:
        return x.to(torch.int32)
    return bloom.to_int32(x)


def _from_wire32(w: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.float32:
        return w.contiguous().view(torch.float32)
    if dtype == torch.bool:
        return w != 0
    return w.to(torch.int64) & MASK


def gather_fields(fields: Sequence[torch.Tensor], mesh,
                  axes: Sequence[str]) -> list:
    """all_gather of equally shaped tensors over possibly several axes,
    each concatenated on its LAST dim in the combined (major-first) rank
    order, leading dims (a serving step's slots) kept: one int32
    all_gather an axis carries them all (the reference's
    ``gather_concat``, one call for several arrays)."""
    packed = torch.stack([_to_wire32(f) for f in fields])     # [F, ..., n]
    for a in reversed(list(axes)):
        g = all_gather(packed, mesh, a)                        # [k, F, ..., n]
        packed = g.movedim(0, -2).flatten(-2)
    return [_from_wire32(packed[i], f.dtype) for i, f in enumerate(fields)]


def rank_block(mesh, axes: Sequence[str], rank: int) -> int:
    """The block of rows ``rank`` holds: its combined index over ``axes``
    (what :func:`combined_axis_index` gives on that rank)."""
    coord = (mesh.mesh == rank).nonzero()[0].tolist()
    idx = 0
    for a in axes:
        idx = idx * axis_size(mesh, a) + coord[mesh.mesh_dim_names.index(a)]
    return idx


def scatter_rows(rel: Optional[Relation], capacity: int, mesh,
                 axes: Sequence[str], device) -> Relation:
    """Rank 0 holds ``rel`` (``capacity`` rows; the other ranks pass None);
    every rank gets its block, the one ``shard_to_mesh`` keeps, by one
    scatter over the default group.  A row travels as three int32s."""
    world = dist.get_world_size()
    n = capacity // mesh_size(mesh, axes)
    gloo = dist.get_backend() == "gloo"
    wdev = torch.device("cpu") if gloo else torch.device(device)
    out = torch.empty((3, n), dtype=torch.int32, device=wdev)
    chunks = None
    if dist.get_rank() == 0:
        wire = torch.stack([_to_wire32(x) for x in rel]).to(wdev)
        wire = wire.view(3, -1, n)
        chunks = [wire[:, rank_block(mesh, axes, r)].contiguous()
                  for r in range(world)]

    def body():
        dist.scatter(out, chunks, src=0)
        return out.to(device)
    got = _metered("scatter", device,
                   out.numel() * 4 * (world - 1) if chunks else 0, body,
                   "scatter", None)
    return Relation(_from_wire32(got[0], torch.int64),
                    _from_wire32(got[1], torch.float32),
                    _from_wire32(got[2], torch.bool))


def broadcast_from0(x: Optional[torch.Tensor], shape, dtype,
                    device) -> torch.Tensor:
    """Rank 0's ``x`` on every rank (the others pass None and the shape and
    dtype they expect), by one broadcast over the default group."""
    gloo = dist.get_backend() == "gloo"
    wdev = torch.device("cpu") if gloo else torch.device(device)
    if dist.get_rank() == 0:
        w = x.to(wdev).contiguous()
    else:
        w = torch.empty(shape, dtype=dtype, device=wdev)

    def body():
        dist.broadcast(w, src=0)
        return w.to(device)
    sent = w.numel() * w.element_size() * (dist.get_world_size() - 1)
    return _metered("broadcast", device,
                    sent if dist.get_rank() == 0 else 0, body, "broadcast",
                    None)


def or_reduce(words: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """OR-merge partition filters across the mesh (Alg. 1 reduce phase),
    innermost axis first: all_gather, then an OR fold in rank order."""
    for a in reversed(list(axes)):
        gathered = all_gather(words, mesh, a)                  # [k_a, nb, W]
        words = gathered[0]
        for i in range(1, gathered.shape[0]):
            words = words | gathered[i]
    return words


def bucketize(rel: Relation, dest: torch.Tensor, k: int, cap: int):
    """Scatter live rows into ``k`` capacity-bounded send buckets.

    Returns (keys ``[k, cap]`` int64, values ``[k, cap]``, valid ``[k, cap]``,
    overflow ``[]``).  Rows keep their order within a destination (a stable
    sort); rows beyond ``cap`` are dropped and counted.
    """
    n = rel.capacity
    dev = rel.keys.device
    d = torch.where(rel.valid, dest, k)                        # invalid -> k
    order = torch.argsort(d, stable=True)
    ds = d[order]
    pos = torch.arange(n, device=dev)
    is_start = torch.cat([torch.ones(min(n, 1), dtype=torch.bool, device=dev),
                          ds[1:] != ds[:-1]])
    slot = pos - torch.cummax(torch.where(is_start, pos, 0), 0).values
    ok = (ds < k) & (slot < cap)
    # rows that stay out land in the extra last cell, which is cut off
    flat = torch.where(ok, ds * cap + slot, k * cap)
    keys = torch.zeros(k * cap + 1, dtype=torch.int64, device=dev)
    keys[flat] = rel.keys[order]
    vals = torch.zeros(k * cap + 1, dtype=torch.float32, device=dev)
    vals[flat] = rel.values[order]
    valid = torch.zeros(k * cap + 1, dtype=torch.bool, device=dev)
    valid[flat] = ok
    overflow = ((ds < k) & (slot >= cap)).sum()
    return (keys[:-1].view(k, cap), vals[:-1].view(k, cap),
            valid[:-1].view(k, cap), overflow)


def shuffle_by_key(rel: Relation, k: int, cap: int, mesh,
                   axes: Sequence[str], seed):
    """Hash-partition this rank's rows so each key lands on one rank.

    Returns (received Relation ``[k * cap]``, live rows sent to other
    ranks, rows dropped beyond ``cap``).  The receive buffer is
    source-major and ``bucketize`` keeps original row order within a
    bucket, so a key's rows arrive in ascending original global row order:
    a stable local sort by key then reproduces the single-device sorted
    segment exactly.
    """
    return shuffle_many([rel], k, cap, mesh, axes, [seed])[0]


def shuffle_many(rels: Sequence[Relation], k: int, cap: int, mesh,
                 axes: Sequence[str], seeds: Sequence) -> list:
    """:func:`shuffle_by_key` of several relations (a serving step's slots
    and inputs, each routed by its own seed) in one exchange an axis:
    their buckets stack as ``[k, M, 2, cap]``.  On a mesh of several axes
    the bucket dim factors as (size(a0), size(a1), ...) and each factor is
    exchanged over ITS axis: exchanging always on the leading factor would
    route the later axes by source index."""
    me = combined_axis_index(mesh, axes)
    wires, meters = [], []
    for rel, seed in zip(rels, seeds):
        dest = hash2(rel.keys, seed) % k
        keys, vals, valid, overflow = bucketize(rel, dest, k, cap)
        wires.append(torch.stack(
            [bloom.to_int32(torch.where(valid, keys, SENTINEL)),
             vals.view(torch.int32)], dim=1))                  # [k, 2, cap]
        meters.append(((rel.valid & (dest != me)).sum(), overflow))
    m = len(wires)
    sizes = [axis_size(mesh, a) for a in axes]
    x = torch.stack(wires, dim=1).reshape(*sizes, m, 2, cap)
    for i, a in enumerate(axes):
        x = all_to_all(x.movedim(i, 0).contiguous(), mesh, a).movedim(0, i)
    x = x.reshape(k, m, 2, cap)
    out = []
    for j, (sent, overflow) in enumerate(meters):
        rk = x[:, j, 0].reshape(-1).to(torch.int64) & MASK
        rvalid = rk != SENTINEL
        out.append((Relation(torch.where(rvalid, rk, 0),
                             x[:, j, 1].contiguous().view(torch.float32)
                             .reshape(-1), rvalid), sent, overflow))
    return out


# ---------------------------------------------------------------------------
# Gather merge: rebuild the canonical single-device [S] slot layout from the
# per-rank strata.  Every key lives on exactly one rank after the shuffle,
# so sorting the gathered slots by key and cutting to S gives the keys, in
# the order, of a single-device build_strata, and a per-stratum quantity
# computed on the owning rank drops into the slot it takes on one device.
# Each merge takes ``[..., S]`` arrays: a serving step's slots merge in one
# gather.
# ---------------------------------------------------------------------------

def merge_by_key(local_keys: torch.Tensor, fields: Sequence[torch.Tensor],
                 mesh, axes: Sequence[str], max_strata: int):
    """Key-sort per-rank ``[..., S]`` slot arrays into canonical ``[..., S]``
    slots.

    Returns ``(keys, merged_fields)``; slots past ``max_strata`` (the
    largest keys, ``build_strata``'s drop rule) are cut.
    """
    g = gather_fields([local_keys, *fields], mesh, axes)
    order = torch.argsort(g[0], dim=-1, stable=True)  # SENTINEL slots last
    order = order[..., :max_strata]
    return (torch.take_along_dim(g[0], order, -1),
            [torch.take_along_dim(f, order, -1) for f in g[1:]])


def merge_strata(local: Sequence[Strata], mesh, axes: Sequence[str],
                 max_strata: int) -> list:
    """Each slot's merged Strata in the canonical single-device layout (on
    every rank), all slots in one gather.

    ``starts`` are zeroed: they index per-rank sorted arrays and mean
    nothing globally; nothing after the merge reads them.
    """
    S = max_strata
    n_sides = local[0].counts.shape[0]
    total = psum(torch.stack([ls.valid.sum() + ls.overflow for ls in local]),
                 mesh, axes)                                   # [B]
    keys, counts = merge_by_key(
        torch.stack([ls.keys for ls in local]),
        [torch.stack([ls.counts[i] for ls in local]) for i in range(n_sides)],
        mesh, axes, S)                                         # [B, S] each
    valid = torch.arange(S, device=keys.device) \
        < torch.clamp(total, max=S)[:, None]
    keys = torch.where(valid, keys, SENTINEL)
    counts = torch.stack([torch.where(valid, c, 0) for c in counts], dim=1)
    over = torch.clamp(total - S, min=0)
    return [Strata(keys[b], valid[b], torch.zeros_like(counts[b]), counts[b],
                   over[b]) for b in range(len(local))]


def merged_to_local(merged_keys: torch.Tensor, local_strata: Strata,
                    merged_vals: torch.Tensor, fill=0.0) -> torch.Tensor:
    """Route a merged-``[S]`` per-stratum array back to this rank's slots."""
    S = merged_keys.shape[0]
    pos = torch.clamp(torch.searchsorted(merged_keys, local_strata.keys),
                      0, S - 1)
    hit = local_strata.valid & (merged_keys[pos] == local_strata.keys)
    return torch.where(hit, merged_vals[pos], fill)


# ---------------------------------------------------------------------------
# Per-rank stage functions, mirroring core/join.py's prepare / exact /
# sample split.  Each runs a list of slots (one for a lone join, a serving
# step's B): the local work per slot, and each collective once for all of
# them, as the reference's vmap over the slots batches its collectives.
# ---------------------------------------------------------------------------

class DistPrepareOut(NamedTuple):
    """Distributed stages 1-3 output of one slot.

    ``sorted_rels`` / ``local_strata`` are this rank's working state;
    ``strata`` / ``population`` / the counters are the same on every rank,
    merged into the canonical single-device layout (gather merge) or this
    rank's own strata (psum merge).
    """

    sorted_rels: list                    # this rank's shuffled, sorted rows
    local_strata: Strata                 # this rank's [S] slots
    strata: Strata                       # merged canonical [S]
    live_counts: torch.Tensor            # int64 [n] global
    total_counts: torch.Tensor           # int64 [n] global
    population: torch.Tensor             # f32 [S] merged
    shuffled_tuple_bytes: torch.Tensor   # f32 [] global live bytes moved
    device_shuffled_bytes: torch.Tensor  # f32 [k] per-rank bytes sent
    bucket_overflow: torch.Tensor        # int64 [] global dropped rows
    device_dropped: torch.Tensor         # int64 [k] per-rank dropped rows
    filter_bytes: torch.Tensor           # f32 [] filter traffic (model)


def dist_prepare_stage(slots: Sequence[Sequence[Relation]], num_blocks: int,
                       max_strata: int, seeds: Sequence, mesh,
                       axes: Sequence[str], *,
                       bucket_cap: Optional[int] = None,
                       filter_words: Optional[Sequence[torch.Tensor]] = None,
                       filter_stage: bool = True,
                       merge: str = "gather",
                       use_kernels: bool = False) -> list:
    """Filter build/OR/AND/probe, key shuffle, local sort + group-by, merge:
    one :class:`DistPrepareOut` a slot.

    ``slots`` holds each slot's relations (this rank's blocks), ``seeds``
    each slot's filter seed.  ``filter_words`` (a slot's ``[n, num_blocks,
    8]`` words, the same on every rank) skips the build and OR: the
    serving engine passes its cached dataset filters.  ``merge='psum'``
    skips the strata gather: ``strata`` / ``population`` are then this
    rank's own strata, with the overflow summed over the ranks.
    ``use_kernels`` builds and probes the filters through the build and
    probe kernels (their plain versions on CPU tensors).
    """
    axes = tuple(axes)
    k = mesh_size(mesh, axes)
    n_rels = len(slots[0])
    local_n = slots[0][0].capacity
    dev = slots[0][0].keys.device
    totals = [torch.stack([r.count() for r in rels]) for rels in slots]

    if filter_stage:
        if use_kernels:
            from repro_torch.kernels import ops as kops
            build, contains = kops.build_filter, (
                lambda jf, keys: kops.probe_filter(jf.words, keys, jf.seed))
        else:
            build, contains = bloom.build, bloom.contains
        if filter_words is None:
            parts = torch.stack([build(r.keys, r.valid, num_blocks,
                                       seed).words
                                 for rels, seed in zip(slots, seeds)
                                 for r in rels])
            merged = or_reduce(parts, mesh, axes)       # [B * n, nb, 8]
            filter_words = [merged[b * n_rels:(b + 1) * n_rels]
                            for b in range(len(slots))]
        probed = []
        for rels, words, seed in zip(slots, filter_words, seeds):
            jf = bloom.intersect_all(
                [bloom.BloomFilter(words[i], seed) for i in range(n_rels)])
            probed.append([Relation(r.keys, r.values,
                                    r.valid & contains(jf, r.keys))
                           for r in rels])
        slots = probed
        # the all-gather restatement of the §3.1 (n + 1) filter-exchange
        # model (core.join.filter_exchange_bytes): each of the n + 1
        # logical filter transfers costs (k - 1) hops on a k-rank mesh
        fbytes = float(num_blocks * bloom.WORDS_PER_BLOCK * 4 * (k - 1)
                       * (n_rels + 1))
    else:
        fbytes = 0.0
    lives = [torch.stack([r.count() for r in rels]) for rels in slots]
    total_counts, live_counts = psum(
        torch.stack([torch.stack(totals), torch.stack(lives)]), mesh, axes)

    # one partitioner for ALL relations (cogroup semantics): matching keys
    # must land on the same rank.  cap = local_n can never overflow (a
    # source holds local_n rows); smaller caps trade memory for counted drops
    cap = bucket_cap or max(2 * local_n // k, 8)
    shuffled = shuffle_many([r for rels in slots for r in rels], k, cap,
                            mesh, axes,
                            [seed + 101 for seed in seeds
                             for _ in range(n_rels)])
    per_slot = [shuffled[b * n_rels:(b + 1) * n_rels]
                for b in range(len(slots))]
    sent = torch.stack([sum(s for _, s, _ in sh) for sh in per_slot])
    dropped = torch.stack([torch.as_tensor(sum(o for _, _, o in sh),
                                           device=dev) for sh in per_slot])
    # dropped tuples count at the SENDING rank (rows beyond the bucket plan
    # never leave it), per rank, never silent
    device_sent, device_dropped = gather_fields(
        [(sent * TUPLE_BYTES).to(torch.float32)[:, None], dropped[:, None]],
        mesh, axes)                                            # [B, k]

    sorted_slots = [[sort_by_key(r) for r, _, _ in sh] for sh in per_slot]
    local = [build_strata(sr, max_strata) for sr in sorted_slots]
    fb = torch.tensor(fbytes, dtype=torch.float32, device=dev)
    if merge == "psum":
        over = psum(torch.stack([ls.overflow for ls in local]), mesh, axes)
        local = [ls._replace(overflow=o) for ls, o in zip(local, over)]
        merged = local
    else:
        merged = merge_strata(local, mesh, axes, max_strata)
        local = [ls._replace(overflow=m.overflow)
                 for ls, m in zip(local, merged)]
    return [DistPrepareOut(sorted_slots[b], local[b], merged[b],
                           live_counts[b], total_counts[b],
                           merged[b].population.to(torch.float32),
                           device_sent[b].sum(),
                           device_sent[b], device_dropped[b].sum(),
                           device_dropped[b], fb)
            for b in range(len(slots))]


def dist_exact_stage(preps: Sequence[DistPrepareOut], mesh,
                     axes: Sequence[str], *, agg: str = "sum",
                     expr: str = "sum") -> list:
    """§3.1.1 exact path: per-rank per-stratum sums, merged, finished;
    ``(estimate, count)`` a slot.

    A stratum's rows lie on one rank in their single-device order, so its
    segment sum there equals the single-device one bit for bit; the merge
    re-slots the sums and ``exact_stage_from_sums`` finishes them as the
    single-device stage does.
    """
    S = preps[0].strata.keys.shape[0]
    sums = torch.stack([per_stratum_value_sums(p.sorted_rels, p.local_strata)
                        for p in preps])                       # [B, n, S]
    _, merged = merge_by_key(
        torch.stack([p.local_strata.keys for p in preps]),
        [sums[:, i] for i in range(sums.shape[1])], mesh, axes, S)
    out = []
    for b, p in enumerate(preps):
        S_k = torch.stack([torch.where(p.strata.valid, m[b], 0.0)
                           for m in merged])
        out.append(exact_stage_from_sums(S_k, p.strata, agg=agg, expr=expr))
    return out


def _sample(p: DistPrepareOut, b_local: torch.Tensor, b_max: int, seed,
            f, expr: Optional[str]) -> SampleResult:
    """This rank's draws over its strata: the sampler kernel (its plain
    version on CPU tensors) for a two-way join of the named ``expr``, else
    :func:`sample_edges` with ``f``."""
    if expr is None or len(p.sorted_rels) != 2:
        return sample_edges(p.sorted_rels, p.local_strata, b_local, b_max,
                            seed, f)
    from repro_torch.core.join import _kernel_sample_result
    from repro_torch.kernels import ops as kops
    return _kernel_sample_result(kops.sample_stats(
        p.sorted_rels, p.local_strata, b_local, b_max, seed, expr))


def dist_sample_stage(preps: Sequence[DistPrepareOut],
                      b_merged: Sequence[torch.Tensor], b_max: int,
                      seeds: Sequence, mesh, axes: Sequence[str], *,
                      agg: str = "sum", dedup: bool = False,
                      confidence: float = 0.95, f_fn=None,
                      kernel_expr: Optional[str] = None) -> list:
    """Stages 4-6: local draws, merged statistics, canonical finish;
    ``(value, err, cnt, dof, merged stats)`` a slot.

    ``b_merged`` is each slot's per-stratum sample size in the MERGED
    ``[S]`` layout (the array a single-device driver decides); each rank
    takes its strata's sizes by key.  Draws are keyed on the join key, so
    the owning rank reproduces the single-device per-stratum statistics
    exactly.  ``kernel_expr`` (not with ``dedup``) draws through the
    sampler kernel (``_sample``).
    """
    S = preps[0].strata.keys.shape[0]
    f = EXPRS["sum"][0] if f_fn is None else f_fn
    fields = []
    for p, b, seed in zip(preps, b_merged, seeds):
        b_local = merged_to_local(p.strata.keys, p.local_strata,
                                  b.to(torch.float32))
        sample = _sample(p, b_local, b_max, seed, f, kernel_expr)
        st = sample.stats
        # the populations cross no wire (it carries 32 bits an element):
        # the merged strata's exact counts give them again
        fields.append([st.valid, st.n_sampled, st.sum_f, st.sum_f2,
                       sample.unique_f, sample.unique_count])
    _, merged = merge_by_key(
        torch.stack([p.local_strata.keys for p in preps]),
        [torch.stack([fl[i] for fl in fields]) for i in range(6)], mesh,
        axes, S)
    out = []
    for b, p in enumerate(preps):
        ok = merged[0][b] & p.strata.valid
        vals = [torch.where(ok, m[b], 0.0) for m in merged[1:]]
        mstats = StratumStats(ok, torch.where(ok, p.strata.population, 0),
                              *vals[:3])
        msample = SampleResult(mstats, vals[3], vals[4],
                               vals[0].new_zeros((1, 1)),
                               torch.zeros((1, 1), dtype=torch.bool,
                                           device=ok.device))
        out.append((*estimate_stage(msample, agg=agg, dedup=dedup,
                                    confidence=confidence), mstats))
    return out


def dist_exact_stage_psum(preps: Sequence[DistPrepareOut], mesh,
                          axes: Sequence[str], *, agg: str = "sum",
                          expr: str = "sum") -> list:
    """Exact path, paper dataflow: per-rank totals merged by one all_reduce
    for all the slots; ``(estimate, count)`` a slot.

    Strata are rank-complete after the shuffle, so per-rank exact
    aggregates ADD across ranks: no strata gather, no re-slot.
    """
    exact_fn = {"sum": exact_sum_of_sums,
                "product": exact_sum_of_products}[expr]
    summed = psum(torch.stack([torch.stack(
        [exact_fn(p.sorted_rels, p.local_strata),
         exact_count(p.local_strata)]) for p in preps]), mesh, axes)
    out = []
    for est, cnt in summed:
        if agg == "count":
            est = cnt
        elif agg == "avg":
            est = est / torch.clamp(cnt, min=1.0)
        out.append((est, cnt))
    return out


def dist_sample_stage_psum(preps: Sequence[DistPrepareOut],
                           b_local: Sequence[torch.Tensor], b_max: int,
                           seeds: Sequence, mesh, axes: Sequence[str], *,
                           agg: str = "sum", dedup: bool = False,
                           confidence: float = 0.95, f_fn=None,
                           kernel_expr: Optional[str] = None) -> list:
    """Stages 4-6, paper dataflow (§3.3-III): local draws, summed parts;
    ``(value, err, cnt, dof, this rank's stats)`` a slot.

    ``b_local`` is each slot's per-stratum budget in THIS rank's slot
    layout.  Every estimator is a sum of per-stratum terms and strata are
    rank-complete, so the merge is one all_reduce of the sufficient parts,
    all the slots' together.  ``kernel_expr`` as in
    :func:`dist_sample_stage`.
    """
    f = EXPRS["sum"][0] if f_fn is None else f_fn
    samples = [_sample(p, b.to(torch.float32), b_max, seed, f, kernel_expr)
               for p, b, seed in zip(preps, b_local, seeds)]
    parts = []
    for sample in samples:
        st = sample.stats
        if dedup:
            parts.append([*ht_sum_parts(st, sample.unique_f,
                                        sample.unique_count), clt_count(st)])
        else:
            extra = [clt_sum_parts(second_moment_stats(st)).tau] \
                if agg == "stdev" else []
            parts.append([*clt_sum_parts(st), clt_count(st), *extra])
    summed = psum(torch.stack([torch.stack(p) for p in parts]), mesh, axes)
    out = []
    for sample, row in zip(samples, summed):
        if dedup:
            *ht, cnt = row
            est = ht_finish(HTParts(*ht), confidence)
        else:
            sp, cnt = SumParts(*row[:5]), row[5]
            if agg == "avg":
                est = clt_avg_from(sp, confidence)
            elif agg == "stdev":
                est = clt_stdev_from(sp, row[6], confidence)
            else:
                est = clt_finish(sp, confidence)
        value = cnt if agg == "count" else est.estimate
        err = torch.zeros_like(est.error_bound) if agg == "count" \
            else est.error_bound
        out.append((value, err, cnt, est.dof, sample.stats))
    return out


def make_distributed_join(mesh, *, n_rels: int,
                          join_axes: Sequence[str] = ("data",),
                          mode: str = "sample",      # 'sample' | 'exact'
                          filter_stage: bool = True,  # False -> repartition
                          expr: str = "sum",
                          sample_fraction: Optional[float] = None,
                          budget: Optional[QueryBudget] = None,
                          cost_model: Optional[CostModel] = None,
                          bucket_cap: Optional[int] = None,
                          max_strata: Optional[int] = None,
                          b_max: int = 1024,
                          confidence: float = 0.95,
                          num_blocks: Optional[int] = None,
                          merge: str = "gather",     # 'gather' | 'psum'
                          seed: int = 0,
                          use_kernels: bool = False):
    """The per-rank join over ``mesh``: every rank calls the returned
    ``run(local_rels, d_dt=0.0)`` with its own block of ``n_rels``
    relations (``core.relation.shard_to_mesh``) and gets the same
    :class:`DistJoinResult`.  ``d_dt`` is the measured filter latency that
    a latency budget's cost function reads.

    ``merge='gather'`` equals the single-device pipeline bit for bit;
    ``merge='psum'`` is the paper's partial-aggregate merge.
    ``use_kernels`` routes the filter build, the probe and the (two-way)
    sampler through the three kernels, as ``approx_join`` does; on CPU
    tensors their plain versions run.
    """
    axes = tuple(join_axes)
    k = mesh_size(mesh, axes)
    f_fn, _ = EXPRS[expr]
    if budget is not None and budget.latency_s is not None \
            and cost_model is None:
        raise ValueError("a latency budget needs a CostModel")
    if merge not in ("gather", "psum"):
        raise ValueError(f"unknown merge {merge!r}")

    def run(rels: Sequence[Relation], d_dt=0.0) -> DistJoinResult:
        if len(rels) != n_rels:
            raise ValueError(f"{len(rels)} relations for n_rels={n_rels}")
        local_n = rels[0].capacity
        S = max_strata or k * (bucket_cap or max(2 * local_n // k, 8))
        prep, = dist_prepare_stage([rels], num_blocks, S, [seed], mesh,
                                   axes, bucket_cap=bucket_cap,
                                   filter_stage=filter_stage, merge=merge,
                                   use_kernels=use_kernels)
        live_total = prep.live_counts.sum().to(torch.float32)
        input_total = prep.total_counts.sum().to(torch.float32)
        # psum merge: population is per-rank, so the global total sums
        total_pop = prep.population.sum()
        if merge == "psum":
            total_pop = psum(total_pop, mesh, axes)
        meters = dict(
            shuffled_tuple_bytes=prep.shuffled_tuple_bytes,
            filter_bytes=prep.filter_bytes,
            live_total=live_total, input_total=input_total,
            overlap_fraction=live_total / torch.clamp(input_total, min=1),
            bucket_overflow=prep.bucket_overflow,
            strata_overflow=prep.strata.overflow,
            total_population=total_pop,
            device_shuffled_bytes=prep.device_shuffled_bytes,
            device_dropped=prep.device_dropped)
        zero = torch.zeros((), device=total_pop.device)

        if mode == "exact":
            exact = dist_exact_stage_psum if merge == "psum" \
                else dist_exact_stage
            (est, cnt), = exact([prep], mesh, axes, agg="sum", expr=expr)
            return DistJoinResult(est, zero, cnt, zero, sample_draws=zero,
                                  **meters)

        # --- stage 4: b_i from the budget (§3.2) ---
        if sample_fraction is not None:
            s = sample_fraction
        elif budget is not None and budget.latency_s is not None:
            s = fraction_for_latency(cost_model, budget.latency_s, d_dt,
                                     total_pop)
        elif budget is not None and budget.error is not None:
            s = budget.pilot_fraction
        else:
            raise ValueError("sample mode needs a fraction or a budget")

        # --- stage 5: sample during join + merge (§3.3/§3.4) ---
        kexpr = expr if use_kernels else None
        if merge == "psum":
            # size b_i off each rank's own strata: every local stratum
            # gets its budget (no global-[S] cut)
            b_local = _pilot_sizes(prep.local_strata.population, s)
            (value, err, cnt, dof, st), = dist_sample_stage_psum(
                [prep], [b_local], b_max, [seed + 1], mesh, axes, agg="sum",
                confidence=confidence, f_fn=f_fn, kernel_expr=kexpr)
            return DistJoinResult(value, err, cnt, dof,
                                  sample_draws=psum(st.n_sampled.sum(), mesh,
                                                    axes), **meters)
        b_merged = _pilot_sizes(prep.population, s)
        (value, err, cnt, dof, mstats), = dist_sample_stage(
            [prep], [b_merged], b_max, [seed + 1], mesh, axes, agg="sum",
            dedup=False, confidence=confidence, f_fn=f_fn, kernel_expr=kexpr)
        return DistJoinResult(value, err, cnt, dof,
                              sample_draws=mstats.n_sampled.sum(), **meters)

    return run


def distributed_approx_join(mesh, rels: Sequence[Relation],
                            fp_rate: float = 0.01,
                            join_axes: Sequence[str] = ("data",),
                            **kw) -> DistJoinResult:
    """Every rank passes the same whole relations; each keeps its block of
    the rows (``shard_to_mesh``), sizes the filter from the whole inputs
    and runs the join once."""
    num_blocks = bloom.num_blocks_for(max(r.capacity for r in rels), fp_rate)
    run = make_distributed_join(mesh, n_rels=len(rels), join_axes=join_axes,
                                num_blocks=num_blocks, **kw)
    return run([shard_to_mesh(r, mesh, join_axes) for r in rels])


# ---------------------------------------------------------------------------
# Serving stages: the per-rank stages over an engine's slot-stacked batch
# (``[B, ...]`` leaves, the first ``n_real`` slots real, the rest repeating
# the last).  The real slots run together, each collective once for all of
# them, on every rank; outputs cover all B slots, as the single-device
# stages'.
# ---------------------------------------------------------------------------

def _rels_of(flat: Sequence[Relation], b: int) -> list:
    return [Relation(r.keys[b], r.values[b], r.valid[b]) for r in flat]


def _preps(prep, n_real: int) -> list:
    return [_slot(prep, b) for b in range(n_real)]


def make_serve_prepare(mesh, axes: Sequence[str], *, n_rels: int,
                       num_blocks: int, max_strata: int,
                       bucket_cap: Optional[int] = None,
                       merge: str = "gather"):
    """Batched distributed prepare: ``(rels_b, words_b, seeds, n_real) ->
    DistPrepareOut`` stacked over the slots.

    ``rels_b`` are this rank's blocks, ``[B, N / k]`` a field;
    ``words_b`` is ``[B, n, nb, 8]``, the cached dataset filters.  With
    ``merge='psum'`` the ``strata`` / ``population`` members come back as
    the concatenation of the ranks' own strata (rank d's slots at columns
    ``[d*S, (d+1)*S)``, ``starts`` zeroed): a complete, disjoint cover of
    the global strata, in which the engine sizes the sample.
    """
    axes = tuple(axes)

    def run(rels_b, words_b, seeds, n_real):
        preps = dist_prepare_stage(
            [_rels_of(rels_b, b) for b in range(n_real)], num_blocks,
            max_strata, list(seeds[:n_real]), mesh, axes,
            bucket_cap=bucket_cap, filter_words=list(words_b[:n_real]),
            merge=merge)
        if merge == "psum":
            ls = [p.local_strata for p in preps]
            keys, valid, pop, *counts = gather_fields(
                [torch.stack([x.keys for x in ls]),
                 torch.stack([x.valid for x in ls]),
                 torch.stack([p.population for p in preps]),
                 *(torch.stack([x.counts[i] for x in ls])
                   for i in range(n_rels))], mesh, axes)   # [B, k*S] each
            counts = torch.stack(counts, dim=1)
            preps = [p._replace(strata=Strata(
                keys[b], valid[b], torch.zeros_like(counts[b]), counts[b],
                p.local_strata.overflow), population=pop[b])
                for b, p in enumerate(preps)]
        return pad_stack(preps, words_b.shape[0])
    return run


def make_serve_sample(mesh, axes: Sequence[str], *, b_max: int, agg: str,
                      dedup: bool, confidence: float, expr: str):
    """Batched distributed sample + estimate: ``(prep, b_merged_b, seeds,
    n_real) -> (value, err, cnt, dof, merged stats)``, each ``[B, ...]``,
    over the batched prepare's output ``prep``."""
    axes = tuple(axes)
    f_fn = EXPRS[expr][0]

    def run(prep, b_merged, seeds, n_real):
        return pad_stack([list(o) for o in dist_sample_stage(
            _preps(prep, n_real), list(b_merged[:n_real]), b_max,
            list(seeds[:n_real]), mesh, axes, agg=agg, dedup=dedup,
            confidence=confidence, f_fn=f_fn)], b_merged.shape[0])
    return run


def make_serve_exact(mesh, axes: Sequence[str], *, agg: str, expr: str):
    """Batched distributed exact path: ``(prep, n_real) -> (estimate [B],
    count [B])``."""
    axes = tuple(axes)

    def run(prep, n_real):
        return pad_stack([list(o) for o in dist_exact_stage(
            _preps(prep, n_real), mesh, axes, agg=agg, expr=expr)],
            prep.strata.keys.shape[0])
    return run


def make_serve_sample_psum(mesh, axes: Sequence[str], *, b_max: int,
                           agg: str, dedup: bool, confidence: float,
                           expr: str):
    """Batched psum-merge sample + estimate.

    ``(prep, b, seeds, n_real)``: ``b`` arrives in the concatenated
    per-rank layout ``[B, k*S]`` (the layout
    ``make_serve_prepare(merge='psum')`` gave its strata in); each rank
    takes its own columns.  Estimates are the same on every rank; the
    per-stratum statistics come back concatenated, ``[B, k*S]``, in the
    layout the engine sized ``b`` in.
    """
    axes = tuple(axes)
    f_fn = EXPRS[expr][0]

    def run(prep, b, seeds, n_real):
        S = prep.local_strata.keys.shape[-1]
        d = combined_axis_index(mesh, axes)
        outs = dist_sample_stage_psum(
            _preps(prep, n_real), list(b[:n_real, d * S:(d + 1) * S]), b_max,
            list(seeds[:n_real]), mesh, axes, agg=agg, dedup=dedup,
            confidence=confidence, f_fn=f_fn)
        stats = gather_fields([torch.stack([o[4][i] for o in outs])
                               for i in range(len(StratumStats._fields))],
                              mesh, axes)                  # [B, k*S] each
        return pad_stack([[*o[:4], StratumStats(*(f[i] for f in stats))]
                          for i, o in enumerate(outs)], b.shape[0])
    return run


def make_serve_exact_psum(mesh, axes: Sequence[str], *, agg: str, expr: str):
    """Batched psum-merge exact path: ``(prep, n_real) -> (estimate [B],
    count [B])``."""
    axes = tuple(axes)

    def run(prep, n_real):
        return pad_stack([list(o) for o in dist_exact_stage_psum(
            _preps(prep, n_real), mesh, axes, agg=agg, expr=expr)],
            prep.local_strata.keys.shape[0])
    return run


def make_serve_filter_build(mesh, axes: Sequence[str], *, num_blocks: int,
                            use_kernels: bool = False):
    """Distributed dataset-filter build: ``(local keys, local valid, seed)
    -> words``, the same on every rank.

    The OR-reduce of the per-rank partition filters equals a single build
    over all the rows bit for bit (scatter-OR is a set union), so the words
    are interchangeable with single-device ones.  ``use_kernels`` builds
    each partition filter with the build kernel (its plain version on the
    CPU).
    """
    axes = tuple(axes)

    def run(keys, valid, seed):
        if use_kernels:
            from repro_torch.kernels import ops as kops
            words = kops.build_filter(keys, valid, num_blocks, seed).words
        else:
            words = bloom.build(keys, valid, num_blocks, seed).words
        return or_reduce(words, mesh, axes)
    return run
