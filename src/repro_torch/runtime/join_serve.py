"""Batched multi-tenant ApproxJoin serving engine, on one device or a mesh.

The port of the JAX package's ``runtime/join_serve.py``.  The
``JoinServer`` batches ApproxJoin queries the way LLM serving
engines batch token decodes across slots.  A :class:`JoinRequest` carries
relations (or named dataset handles), a :class:`QueryBudget`, the
aggregate/expression, and a tenant ``query_id``.  The engine:

* **buckets** every relation to a power-of-two capacity
  (:func:`repro_torch.core.relation.bucket_to_pow2`) so queries fall into a
  small number of *shape classes*;
* calls each step's stages directly (PyTorch compiles nothing) and keeps
  the set of stage keys ``(stage, shape_class, batch)`` it has served: a
  key's first sight counts in ``ServerDiagnostics.compiles`` and every
  later one in ``cache_hits`` (the JAX package's diagnostics), and the
  first prepare of a class at a width runs once more off the clock, where
  it loads the CUDA kernels and makes PyTorch's first allocations;
* **batches same-shape-class queries** across the filter-probe/sort/strata
  and sample/estimate stages.  On the kernel route (``use_kernels=True``)
  one engine step is one launch of the probe per input and one of the
  sampler for the whole batch, whatever its width: the kernels own the slot
  dimension (``core.join.prepare_stage_kernels_batched`` /
  ``sample_stage_kernels_batched``), and only the sort/strata tail and the
  estimator finish run per slot.  The plain route runs the per-query stages
  slot by slot and stacks them;
* caches **per-dataset Bloom filter words** keyed by
  ``(relation fingerprint, num_blocks, seed)``: a registered dataset pays
  the filter build once, then every later step reuses the cached words
  (``ServerDiagnostics.filter_builds`` / ``filter_cache_hits``);
* shares one :class:`SigmaRegistry` and :class:`CostModel` across tenants, so
  a repeated ``query_id`` gets the paper's §3.2-II adaptive sample sizing,
  and tenants never see each other's sigmas (the registry is keyed by
  ``query_id``).

Results are bit-identical to a direct :func:`repro_torch.core.join.approx_join`
call on the same (bucketed) relations with the same seed.  That rests on
every float sum of a slot being added in a fixed order: the CUDA kernels add
theirs so, and the exact stage sums each stratum's values as a segment sum,
not as a scatter of atomic adds.  The tests hold it on the CPU on both
routes, and on the card on the kernel route, with whole-number and with
fractional values; the plain route on the card is not tested.

Per-query dynamic decisions (exact-affordable?  per-stratum ``b_i`` from the
budget + sigma feedback) stay on the host, exactly as in ``approx_join``.
Sigma feedback lands *between engine steps*, which is why the scheduler runs
**cross-step sigma pipelining** (``sigma_pipeline``, on by default):
same-``query_id`` error-budget repeats are deferred to the NEXT step, so
every execution sees the previous one's measured sigma, bit-identical to a
sequential driver, and the freed slot fills with the next same-class query.

Scheduling is FIFO until the queue backs up past ``backlog_slots``, then
**deadline-aware**: latency-budget queries (deadline = submission +
``latency_s``) are served before error-budget/exact ones (deadline
infinity), FIFO on ties.  Queue latency is tracked as a bounded sample ring
and surfaced as p50/p95/max in ``ServerDiagnostics.snapshot()``.

A kernel class's batch width is bounded by device memory (:func:`slot_bytes`
and :func:`slot_budget`); the CUDA kernels have no size limit of their own.

``JoinRequest.filter_seed`` decouples the filter hash from the sampling
seed, and ``_words`` carries prebuilt filter words past the per-dataset
cache: a streaming window's OR-merged sub-window words
(``runtime/stream_join.py``, whose admission control marks a request it
drops ``shed``).

Query plans (:mod:`repro_torch.core.plan`) compile once per signature and
submit one request per node (:meth:`JoinServer.submit_plan`), each over the
concatenation of its leaf datasets.  :meth:`JoinServer.snapshot_state` /
:meth:`JoinServer.restore_state` capture and adopt the serving state
(datasets, cached filter words, sigmas, the queue with its plans), which
``runtime/checkpoint.py`` writes and the async tier's failover reads.

**On a mesh** (``JoinServer(mesh=...)``, ``core/distributed.py``) one
process a rank serves: the server on rank 0 is the engine the caller sees,
and ranks 1..k-1 run :func:`serve_mesh_worker`.  Before each mesh operation
(scatter a relation, build a dataset filter, prepare, sample, exact,
gather rows, stop) rank 0 broadcasts a small header, and every rank then
runs the same per-rank function on its own block of the rows, each
collective once for all of the step's slots.  Batching,
deadlines and sigma lookups read the clock and host state, so only rank 0
decides them; ranks that decided on their own would issue collectives in
different orders.  ``serve_mode`` picks the merge:

* ``'exact-parity'`` (default): gather merge, lossless buckets; results
  equal the single-device server's bit for bit at any mesh size.
* ``'psum'``: one all_reduce of estimator parts, buckets planned from the
  dataset's Bloom-intersection overlap estimate; accuracy is statistical
  and dropped rows are counted.

Kernel classes on a mesh are single-device classes: at mesh 1 they serve
with no gather; at k > 1 rank 0 gathers their datasets' rows (metered in
``kernel_gather_bytes``) and the CUDA kernels serve them there, with their
dataset filters built by the build kernel on every rank and OR-merged.  A
kernel request's inline relations stay on rank 0 (nothing to scatter and
gather back).

Everything the single-device server serves is served on a mesh too:

* **plans**: ``compile_plan``'s byte model reads each dataset's rows once
  per plan signature, gathered to rank 0 (metered in ``host_gather_bytes``);
  node requests are ordinary mesh requests, n-way ones included;
* **prebuilt words** (a streaming window's OR of its sub-window filters):
  a mesh class needs them on every rank under a word id.  A request whose
  ``_word_keys`` name words the ranks already hold sends nothing but the
  ids; one without (a restored request) broadcasts its words once, for the
  step that serves it;
* **snapshots**: ``snapshot_state`` gathers every relation to rank 0 in its
  global row order, so the checkpoint format stays the JAX package's and
  mesh-agnostic, and ``restore_state`` scatters what it restores onto this
  server's mesh (any size or layout); restored filter words reach the ranks
  under fresh word ids the first time a mesh class needs them.

Several mesh servers may share the same ranks (the replicas of an async
front door, a dead replica and its successor): every server has a server
id, its headers carry it, each rank keeps one state per id, and on rank 0
one lock makes each operation (header plus collectives) atomic across
servers and threads.  ``shutdown()`` ends one server's state on the ranks;
:func:`close_mesh_workers` ends the worker loops.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
import weakref
from collections import OrderedDict
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import bloom
from repro_torch.core.budget import QueryBudget
from repro_torch.core.cost import CostModel, SigmaRegistry, sync
from repro_torch.core.distributed import (broadcast_from0, gather_fields,
                                          make_serve_exact,
                                          make_serve_exact_psum,
                                          make_serve_filter_build,
                                          make_serve_prepare,
                                          make_serve_sample,
                                          make_serve_sample_psum, mesh_size,
                                          planned_bucket_cap, scatter_rows)
from repro_torch.core.estimators import SumParts
from repro_torch.core.hashing import MASK
from repro_torch.core.join import (EXPRS, TUPLE_BYTES, JoinDiagnostics,
                                   JoinResult, _slot, decide_sample_sizes,
                                   exact_stage, filter_exchange_bytes,
                                   measured_sigma, pad_stack,
                                   prepare_stage_kernels_batched,
                                   prepare_stage_pre, sample_stage,
                                   sample_stage_kernels_batched)
from repro_torch.core.plan import CompiledPlan, Plan, compile_plan
from repro_torch.core.relation import (Relation, bucket_capacity,
                                       bucket_to_pow2, fingerprint, relation)
from repro_torch.runtime.telemetry import (NULL_TRACER, Histogram,
                                           MetricsRegistry, Tracer,
                                           latency_pcts, recon_pair,
                                           span_tree)
from repro_torch.runtime.telemetry import \
    reconciliation_report as _recon_report

DEFAULT_B_MAX = 2048
AGGS = ("sum", "count", "avg", "stdev")
SERVE_MODES = ("exact-parity", "psum")

# Share of the card's memory that one step's slots may hold (slot_budget),
# split evenly among the replicas of an async front door on one card.
# chip_smoke.py holds a step's measured peak to 1.5 x slot_bytes x B, so a
# step at the cap peaks at no more than 0.75 of the card.  The quarter left
# holds the registered datasets and the filter-word cache: at most 256
# entries (JoinServer's filter_cache_entries), 32 MiB each for an input of
# 2^24 rows, 8 GiB in all, a tenth of an 80 GB card.
SLOT_MEMORY_SHARE = 0.5
# The same budget for a step on the CPU, in bytes.
HOST_SLOT_MEMORY = 8 << 30


def tenant_of(query_id: str) -> str:
    """Tenant key of a query id — the ``'/'``-prefix convention
    (``'tenantA/sum0'`` -> ``'tenantA'``; un-prefixed ids are their own
    tenant).  Per-tenant latency percentiles group by it."""
    return query_id.split("/", 1)[0]


def bloom_overlap_estimate(rels: Sequence[Relation], fp_rate: float = 0.01,
                           seed: int = 0) -> float:
    """Planning-time live-fraction estimate from the Bloom intersection.

    Builds one filter per input, ANDs them, probes every input against the
    join filter and returns surviving / total, the estimate a mesh server
    sizes psum-mode shuffle buckets from.  Biased UP only (Bloom false
    positives), so a bucket plan with slack on top errs on the lossless
    side.  Taken once, at dataset registration.
    """
    num_blocks = bloom.num_blocks_for(max(r.capacity for r in rels), fp_rate)
    jf = bloom.intersect_all([bloom.build(r.keys, r.valid, num_blocks, seed)
                              for r in rels])
    live = sum(int((r.valid & bloom.contains(jf, r.keys)).sum())
               for r in rels)
    total = sum(int(r.count()) for r in rels)
    return live / max(total, 1)


class ShapeClass(NamedTuple):
    """Static signature of a query (the stage-cache key).

    ``mesh`` is ``()`` for a single-device server (and for kernel classes),
    else the ordered ``(axis name, axis size)`` pairs of the join axes, so
    the same query stream served on different meshes builds (and caches)
    per mesh shape.  ``serve_mode`` and ``bucket_cap`` key too: the psum
    and exact-parity pipelines are different programs with differently
    sized shuffle buffers.
    """

    caps: tuple[int, ...]    # per-side bucketed capacities
    n_inputs: int
    max_strata: int
    b_max: int
    expr: str
    agg: str
    dedup: bool
    use_kernels: bool
    fp_rate: float
    confidence: float
    mesh: tuple = ()
    serve_mode: str = "exact-parity"
    bucket_cap: int = 0      # mesh classes only; 0 = single-device


@dataclass(eq=False)
class JoinRequest:
    """One tenant query: relations (or dataset handle) + budget + query id.

    ``eq=False``: requests are identities, not values — a generated
    ``__eq__`` would compare the relation tensors, and queue bookkeeping
    must never conflate two requests that happen to carry equal payloads.
    """

    rels: Optional[Sequence[Relation]] = None
    dataset: Optional[str] = None
    # multi-dataset handle (plan-node requests): the fused stage joins the
    # concatenation of the named datasets' relation lists, each resolved
    # through the same fingerprint path as a single-dataset handle, so a
    # table shared by several plan nodes builds its filter words once
    datasets: Optional[Sequence[str]] = None
    budget: QueryBudget = QueryBudget()
    agg: str = "sum"
    expr: str = "sum"
    query_id: str = "q0"
    seed: int = 0
    fp_rate: float = 0.01
    max_strata: Optional[int] = None
    b_max: Optional[int] = DEFAULT_B_MAX
    dedup: bool = False
    use_kernels: bool = False
    serve_mode: Optional[str] = None   # None -> the server's default
    # filter-hash seed, decoupled from the sampling seed so a streaming
    # session can vary draws per window while reusing cached filter words
    # (None -> ``seed``, the classic coupled behaviour)
    filter_seed: Optional[int] = None
    # psum bucket planning on a mesh: a live-fraction estimate overriding
    # the dataset's registration-time one
    overlap_hint: Optional[float] = None
    # streaming metadata (carried into the trace)
    stream: Optional[str] = None
    window_id: Optional[int] = None
    # plan metadata (set by submit_plan): the owning plan's id and this
    # request's node name within it; restore_state regroups requests
    # carrying these into live PlanHandles, so a failover never drops an
    # in-flight plan
    plan: Optional[str] = None
    plan_node: Optional[str] = None
    # filled by the server
    result: Optional[JoinResult] = None
    done: bool = False
    shed: bool = False                 # dropped by admission control, unserved
    queue_latency_s: float = 0.0       # ingest -> dispatch (batch former wait)
    e2e_latency_s: float = 0.0         # ingest -> complete
    _class: Optional[ShapeClass] = field(default=None, repr=False)
    _submit_t: float = field(default=0.0, repr=False)
    # ingest -> dispatch -> complete timestamps (perf_counter); a front
    # door may pre-stamp _ingest_t, else submit() does (== _submit_t)
    _ingest_t: float = field(default=0.0, repr=False)
    _dispatch_t: float = field(default=0.0, repr=False)
    _complete_t: float = field(default=0.0, repr=False)
    # per-query completion future (async tier); resolved by the engine's
    # on_done hook for served AND shed requests
    _future: Optional[object] = field(default=None, repr=False)
    _fps: Optional[list[str]] = field(default=None, repr=False)
    # prebuilt per-side filter words; when set, the batch path uses them
    # verbatim instead of fetching through the per-dataset cache
    _words: Optional[list] = field(default=None, repr=False)
    # on a mesh: the word ids under which every rank holds ``_words`` (a
    # streaming window's OR, made on the ranks); released once served
    _word_keys: Optional[list] = field(default=None, repr=False)
    # compile-time byte model of the owning plan node (submit_plan copies
    # the node's node_bytes_model dict here): the reconciliation report
    # pairs its bytes_pushdown against the serve-time restatement
    _bytes_model: Optional[dict] = field(default=None, repr=False)
    # tracer span id grouping every span of this request's execution
    # (unique per request instance, survives failover via Tracer.adopt)
    _span_id: Optional[int] = field(default=None, repr=False)


@dataclass
class PlanHandle:
    """An in-flight plan: one engine request per plan node.

    Node requests ride the normal queue (their query ids are
    ``'<plan_id>/<node>'``, so the whole plan is one tenant to the front
    door) and the handle is just the grouping: the engine tracks live
    handles in ``JoinServer.plans`` and drops a handle once every node
    finished, and ``restore_state`` rebuilds handles from the requests'
    plan metadata after a failover.
    """

    plan_id: str
    requests: dict = field(default_factory=dict)   # node name -> JoinRequest

    @property
    def done(self) -> bool:
        return all(r.done or r.shed for r in self.requests.values())

    def results(self) -> dict:
        """node name -> JoinResult (finished nodes only)."""
        return {name: r.result for name, r in self.requests.items()
                if r.done and r.result is not None}


# ServerDiagnostics scalar counters in snapshot order (the JAX package's
# schema; the mesh meters stay 0 on a single-device server):
#   queries..kernel_queries — served-query counts by decision/backend
#   queue_latency_s/e2e_latency_s — summed ingest->dispatch / ->complete
#   plan_compiles/plan_cache_hits — compiled-plan cache misses/reuses
#   sigma_deferrals — same-id repeats pushed to the next step
#   deadline_promotions — backlog steps served out of FIFO order
#   filter_s/filter_build_s/filter_builds/filter_cache_hits — Bloom stage
#   shuffled_bytes_saved — repartition-vs-filtered delta over served queries
#   kernel_gather_bytes — host gather bytes for kernel queries on a mesh
#   dist_shuffled_tuple_bytes, dist_dropped_tuples, dist_wire_bytes_model —
#     mesh shuffle meters
#   filter_exchange_bytes_model — summed §3.1 (n+1)-exchange model over
#     served queries; filter_exchange_bytes_measured its mesh meter
#   tenant_evictions — per-tenant latency rings LRU-evicted past tenant_cap
_DIAG_SCALAR_FIELDS = (
    "queries", "steps", "cache_hits", "compiles", "exact_queries",
    "sampled_queries", "kernel_queries", "queue_latency_s", "e2e_latency_s",
    "plan_compiles", "plan_cache_hits", "sigma_deferrals",
    "deadline_promotions", "filter_s", "filter_build_s", "filter_builds",
    "filter_cache_hits", "shuffled_bytes_saved", "kernel_gather_bytes",
    "dist_shuffled_tuple_bytes", "dist_dropped_tuples",
    "dist_wire_bytes_model", "filter_exchange_bytes_model",
    "filter_exchange_bytes_measured", "tenant_evictions", "max_batch")
# per-device meters (mesh servers only; None here)
_DIAG_VECTOR_FIELDS = ("per_device_shuffled_bytes",
                       "per_device_dropped_tuples")


class ServerDiagnostics:
    """Server-level counters (cumulative since construction).

    Every field is backed by a
    :class:`repro_torch.runtime.telemetry.MetricsRegistry` metric (scalars
    by counters, per-device meters by gauges, the latency rings by
    histograms) — the registry is the single store behind ``snapshot()``
    and the Prometheus export.  Attribute access routes through the
    registry, so ``diag.queries += 1`` call sites work unchanged.

    Per-tenant latency rings are LRU-bounded at ``tenant_cap`` distinct
    tenants (an adversarial tenant-id stream must not grow ``per_tenant``
    without limit); evictions are counted in ``tenant_evictions``.
    """

    _SCALARS = frozenset(_DIAG_SCALAR_FIELDS)
    _VECTORS = frozenset(_DIAG_VECTOR_FIELDS)

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 tenant_cap: int = 256):
        self.registry = MetricsRegistry() if registry is None else registry
        self.tenant_cap = tenant_cap
        for f in _DIAG_SCALAR_FIELDS:
            self.registry.counter("serve_" + f)
        for f in _DIAG_VECTOR_FIELDS:
            self.registry.gauge("serve_" + f)
        # bounded rings of recent per-query latencies; snapshot() reduces
        # each to p50/p95/max (a running sum cannot see tail latency)
        self._q_hist = self.registry.histogram("serve_queue_latencies")
        self._e_hist = self.registry.histogram("serve_e2e_latencies")
        # tenant -> (queue Histogram, e2e Histogram), LRU order
        self._tenants: OrderedDict = OrderedDict()

    def __getattr__(self, name):
        # only reached when normal lookup fails — i.e. the registry-backed
        # fields and the ring views
        d = object.__getattribute__(self, "__dict__")
        reg = d.get("registry")
        if reg is not None:
            if name in self._SCALARS:
                return reg.counter("serve_" + name).value
            if name in self._VECTORS:
                return reg.gauge("serve_" + name).value
            if name == "queue_latencies":
                return d["_q_hist"].samples
            if name == "e2e_latencies":
                return d["_e_hist"].samples
            if name == "tenant_latencies":
                return {t: (qh.samples, eh.samples)
                        for t, (qh, eh) in d["_tenants"].items()}
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in self._SCALARS:
            self.registry.counter("serve_" + name).value = value
        elif name in self._VECTORS:
            self.registry.gauge("serve_" + name).value = value
        else:
            object.__setattr__(self, name, value)

    def note_latency(self, tenant: str, queue_s: float, e2e_s: float,
                     cap: int) -> None:
        """Record one finished query's ingest->dispatch / ingest->complete
        latencies into the global and per-tenant bounded rings."""
        self.queue_latency_s += queue_s
        self.e2e_latency_s += e2e_s
        per = self._tenants.get(tenant)
        if per is None:
            per = (Histogram(f"tenant_queue_latencies/{tenant}", cap),
                   Histogram(f"tenant_e2e_latencies/{tenant}", cap))
            self._tenants[tenant] = per
            while len(self._tenants) > self.tenant_cap:
                self._tenants.popitem(last=False)
                self.tenant_evictions += 1
        else:
            self._tenants.move_to_end(tenant)
        for hist, x in ((self._q_hist, queue_s), (self._e_hist, e2e_s),
                        (per[0], queue_s), (per[1], e2e_s)):
            hist.cap = cap
            hist.observe(x)

    def reset_latencies(self) -> None:
        """Clear the latency sample rings (cumulative counters stay).  A
        bench reusing one warmed server calls this between timed segments
        so warmup-era samples cannot leak into a later segment's
        percentiles."""
        self._q_hist.reset_samples()
        self._e_hist.reset_samples()
        self._tenants.clear()

    def scalars(self) -> dict:
        """The scalar counters as a plain dict."""
        return {f: getattr(self, f) for f in _DIAG_SCALAR_FIELDS}

    def prometheus(self, prefix: str = "repro") -> str:
        """Prometheus text exposition of the backing registry."""
        return self.registry.prometheus(prefix)

    def snapshot(self) -> dict:
        """Point-in-time dict view — strictly read-only and idempotent:
        building a snapshot mutates nothing, and two consecutive snapshots
        of an idle server are equal."""
        d: dict = self.scalars()
        for f in _DIAG_VECTOR_FIELDS:
            v = getattr(self, f)
            d[f] = None if v is None else [float(x) for x in v]
        d.update(latency_pcts(self._q_hist.samples, "queue_latency"))
        d.update(latency_pcts(self._e_hist.samples, "e2e_latency"))
        d["per_tenant"] = {
            t: {"samples": len(qh.samples),
                **latency_pcts(qh.samples, "queue_latency"),
                **latency_pcts(eh.samples, "e2e_latency")}
            for t, (qh, eh) in self._tenants.items()}
        return d


def shape_class_of(req: JoinRequest, mesh_shape: tuple = (),
                   serve_mode: str = "exact-parity",
                   bucket_cap: int = 0) -> ShapeClass:
    caps = tuple(bucket_capacity(r.capacity) for r in req.rels)
    return ShapeClass(caps, len(caps), req.max_strata, req.b_max,
                      req.expr, req.agg, req.dedup, req.use_kernels,
                      req.fp_rate, req.budget.confidence, mesh_shape,
                      serve_mode, bucket_cap)


def kernel_sampler(cls: ShapeClass) -> bool:
    """Whether ``cls`` samples through the fused sampler kernel, which is
    two-way and non-dedup (the paper's hot case); every other class draws
    with plain torch."""
    return cls.use_kernels and cls.n_inputs == 2 and not cls.dedup


def slot_bytes(cls: ShapeClass) -> int:
    """Bytes one slot of a step of ``cls`` holds on its device.

    Per input at its bucketed capacity: the stacked keys, values and
    validity (int64, float32, bool: 13 bytes a row), their sorted copies
    (13) and the prepare tail's argsort indices (int64: 8); the per-input
    filter words and the join filter, ``num_blocks * 32`` bytes each; and
    the strata arrays over ``max_strata`` slots: keys (8 bytes), validity
    (1), per input starts and counts (16), population, ``b_i`` and the
    sampler's three sums (20).  A class that draws with plain torch also
    holds ``[max_strata, b_max]`` grids: per input the drawn indices and
    their in-stratum offsets (int64, 16 bytes a cell) and the gathered
    values (float32, 4), and once the f values, the mask, the edge ids,
    their sort order and the counter hash's temporaries (about 40).
    """
    nb = bloom.num_blocks_for(max(cls.caps), cls.fp_rate)
    rows = sum(cls.caps) * (13 + 13 + 8)
    filters = (cls.n_inputs + 1) * nb * bloom.WORDS_PER_BLOCK * 4
    strata = cls.max_strata * (8 + 1 + 16 * cls.n_inputs + 20)
    grid = 0 if kernel_sampler(cls) else \
        cls.max_strata * cls.b_max * (20 * cls.n_inputs + 40)
    return rows + filters + strata + grid


@functools.cache
def _card_memory(index: int) -> int:
    return torch.cuda.get_device_properties(index).total_memory


def slot_budget(device, share: Optional[float] = None) -> int:
    """Bytes one step's slots may hold on ``device``: ``share`` (by default
    ``SLOT_MEMORY_SHARE``) of the card's memory (read once per card); on
    the CPU ``HOST_SLOT_MEMORY``, scaled by ``share / SLOT_MEMORY_SHARE``."""
    share = SLOT_MEMORY_SHARE if share is None else share
    device = torch.device(device)
    if device.type != "cuda":
        return int(share / SLOT_MEMORY_SHARE * HOST_SLOT_MEMORY)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return int(share * _card_memory(index))


# -- the plain route's stages, slot by slot.  Each takes the engine's
# -- slot-stacked batch plus ``n_real``, the number of slots before the pad
# -- slots (which repeat the last real one); its outputs cover all the
# -- batch's slots. ----------------------------------------------------------

def _prepare_slots(cls: ShapeClass, rels, words, seeds, n_real: int):
    return pad_stack([prepare_stage_pre(_slot(rels, b), words[b],
                                        cls.max_strata, seeds[b])
                      for b in range(n_real)], words.shape[0])


def _sample_slots(cls: ShapeClass, sorted_rels, strata, b_i, seeds,
                  n_real: int):
    f_fn = EXPRS[cls.expr][0]
    return pad_stack([list(sample_stage(
        _slot(sorted_rels, b), _slot(strata, b), b_i[b], cls.b_max, seeds[b],
        agg=cls.agg, dedup=cls.dedup, confidence=cls.confidence, f_fn=f_fn))
        for b in range(n_real)], b_i.shape[0])


def _exact_slots(cls: ShapeClass, sorted_rels, strata, n_real: int):
    return pad_stack([list(exact_stage(_slot(sorted_rels, b),
                                       _slot(strata, b), agg=cls.agg,
                                       expr=cls.expr))
                      for b in range(n_real)], strata.keys.shape[0])


class ShardedRelation:
    """A relation a mesh server holds across its ranks: ``local`` is rank
    0's block of the rows, ``capacity`` the whole relation's, and ``rid``
    names the blocks the other ranks hold, which they drop once this handle
    is gone."""

    def __init__(self, rid: int, local: Relation, capacity: int):
        self.rid, self.local, self.capacity = rid, local, capacity


def _mesh_stage(mesh, axes, spec: tuple):
    """The per-rank serving stage a header's ``spec`` names."""
    name, *a = spec
    if name == "prepare":
        n_rels, num_blocks, max_strata, cap, merge = a
        return make_serve_prepare(mesh, axes, n_rels=n_rels,
                                  num_blocks=num_blocks,
                                  max_strata=max_strata, bucket_cap=cap,
                                  merge=merge)
    if name == "sample":
        merge, b_max, agg, dedup, confidence, expr = a
        make = make_serve_sample_psum if merge == "psum" else \
            make_serve_sample
        return make(mesh, axes, b_max=b_max, agg=agg, dedup=dedup,
                    confidence=confidence, expr=expr)
    if name == "exact":
        merge, agg, expr = a
        make = make_serve_exact_psum if merge == "psum" else make_serve_exact
        return make(mesh, axes, agg=agg, expr=expr)
    num_blocks, use_kernels = a                       # "fbuild"
    return make_serve_filter_build(mesh, axes, num_blocks=num_blocks,
                                   use_kernels=use_kernels)


def _rows_of(rel) -> torch.Tensor:
    """A relation's keys on this rank (rank 0's block of a mesh handle)."""
    return (rel.local if isinstance(rel, ShardedRelation) else rel).keys


# Every header and every collective of a mesh server goes over the ranks of
# the default group, so on rank 0 one lock serialises the operations of all
# the mesh servers of the process (replicas of a front door step from their
# own threads): an operation's header and its collectives reach the ranks
# whole and in one order.
_MESH_LOCK = threading.RLock()
_SERVER_IDS = itertools.count()


class _MeshRank:
    """What every rank holds and runs for one mesh server (``sid``): its
    block of each relation (by ``rid``), the filters (by word id), the
    current step's per-rank prepare output, and the per-rank stages.

    Rank 0's server calls :meth:`call`, which broadcasts the operation's
    header (its server id, and the join axes the first time) to the other
    ranks' :func:`serve_mesh_worker` loops and runs it on rank 0 too, under
    the process's mesh lock.  A header also carries the relations and
    filters rank 0 let go of since the last one; every rank drops them
    after the operation.
    """

    def __init__(self, mesh, axes, device=None, sid: int = 0):
        self.mesh, self.axes, self.sid = mesh, tuple(axes), sid
        self.device = None if device is None else torch.device(device)
        self.rels: dict = {}
        self.words: dict = {}
        self.prep = None
        self._stages: dict = {}
        self._free_rels: list = []
        self._free_words: list = []
        self._opened = False

    def release_rel(self, rid: int) -> None:
        self._free_rels.append(rid)

    def release_words(self, wkey: int) -> None:
        self._free_words.append(wkey)

    def call(self, op: str, payload=None, **header):
        """Rank 0: broadcast ``op``'s header, then run it here."""
        header.update(op=op, sid=self.sid)
        with _MESH_LOCK:
            if not self._opened:
                header["axes"], self._opened = self.axes, True
            header["free_rels"], self._free_rels = self._free_rels, []
            header["free_words"], self._free_words = self._free_words, []
            dist.broadcast_object_list([header], src=0)
            return self.run(header, payload)

    def run(self, h: dict, payload=None):
        try:
            return getattr(self, "_" + h["op"])(h, payload)
        finally:
            self._drop(h)

    def _drop(self, h: dict) -> None:
        for rid in h["free_rels"]:
            self.rels.pop(rid, None)
        for wkey in h["free_words"]:
            self.words.pop(wkey, None)

    def _stage(self, spec: tuple):
        fn = self._stages.get(spec)
        if fn is None:
            fn = self._stages[spec] = _mesh_stage(self.mesh, self.axes, spec)
        return fn

    def _rel(self, h, rel):
        if rel is not None and self.device is None:
            self.device = rel.keys.device
        self.rels[h["rid"]] = local = scatter_rows(
            rel, h["capacity"], self.mesh, self.axes, self.device)
        return local

    def _gather(self, h, _):
        local = self.rels[h["rid"]]
        return Relation(*gather_fields(list(local), self.mesh, self.axes))

    def _fbuild(self, h, _):
        local = self.rels[h["rid"]]
        words = self._stage(("fbuild", h["num_blocks"], h["kernels"]))(
            local.keys, local.valid, h["seed"])
        self.words[h["wkey"]] = words
        return words

    def _words(self, h, words):
        """Rank 0's ``words`` on every rank, under ``wkey``."""
        dev = self.device if words is None else words.device
        self.words[h["wkey"]] = out = broadcast_from0(
            words, h["shape"], torch.int32, dev)
        return out

    def _wor(self, h, _):
        """The OR of the words under ``srcs`` (one rank-local fold), kept
        under ``wkey``: a window's filter from its sub-windows'."""
        out = self.words[h["srcs"][0]]
        for w in h["srcs"][1:]:
            out = out | self.words[w]
        self.words[h["wkey"]] = out
        return out

    def _live(self, h, _):
        """Every rank's relation and word ids (an object all_gather), once
        what rank 0 let go of is dropped."""
        self._drop(h)
        mine = (sorted(self.rels), sorted(self.words))
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, mine)
        return out

    def _prepare(self, h, _):
        slots, n_sides = h["slots"], len(h["slots"][0])
        rels_b = [Relation(*(torch.stack([self.rels[sl[s]][f] for sl in slots])
                             for f in range(3))) for s in range(n_sides)]
        words_b = torch.stack([torch.stack([self.words[w] for w in ws])
                               for ws in h["wkeys"]])
        fseeds = torch.tensor(h["fseeds"], device=self.device)
        self.prep = self._stage(h["spec"])(rels_b, words_b, fseeds,
                                           h["n_real"])
        return self.prep

    def _sample(self, h, b):
        b = broadcast_from0(b, tuple(self.prep.population.shape),
                            torch.float32, self.device)
        seeds = torch.tensor(h["seeds"], device=self.device)
        return self._stage(h["spec"])(self.prep, b, seeds, h["n_real"])

    def _exact(self, h, _):
        return self._stage(h["spec"])(self.prep, h["n_real"])

    def _stop(self, h, _):
        self.rels.clear()
        self.words.clear()
        self.prep = None


class MeshWorkerReport(NamedTuple):
    """What a worker loop ran: operations by server id, in the order the
    servers first spoke, and the servers whose state it still held when
    the loop closed (shut down none of them: ``()``)."""

    ops: dict
    open: tuple


def serve_mesh_worker(mesh, device) -> MeshWorkerReport:
    """The loop of ranks 1..k-1 under the mesh servers of rank 0: run
    every operation they broadcast, each on this rank's state of its
    server (on ``device``), until rank 0 calls
    :func:`close_mesh_workers`.  A server's ``shutdown()`` drops its state
    here."""
    if dist.get_rank() == 0:
        raise ValueError("rank 0 runs the JoinServer; serve_mesh_worker is "
                         "for ranks 1..k-1")
    ranks: dict = {}
    ops: dict = {}
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=0)
        h = box[0]
        if h["op"] == "close":
            return MeshWorkerReport(ops, tuple(ranks))
        sid = h["sid"]
        rank = ranks.get(sid)
        if rank is None:
            rank = ranks[sid] = _MeshRank(mesh, h["axes"], device, sid)
            ops.setdefault(sid, 0)
        rank.run(h)
        if h["op"] == "stop":
            del ranks[sid]
        else:
            ops[sid] += 1


def close_mesh_workers() -> None:
    """Rank 0: end every rank's :func:`serve_mesh_worker` loop (once its
    mesh servers have shut down; a no-op on a mesh of one rank)."""
    with _MESH_LOCK:
        dist.broadcast_object_list([{"op": "close"}], src=0)


class _GatheredDatasets(Mapping):
    """A mesh server's datasets as :func:`compile_plan` reads them: each
    dataset's relations gathered to rank 0 when first read, each relation
    once."""

    def __init__(self, server: "JoinServer"):
        self.server, self._memo = server, {}

    def __getitem__(self, name: str) -> list:
        return [self.server._full_rows(r, self._memo)
                for r in self.server.datasets[name]]

    def __contains__(self, name) -> bool:
        return name in self.server.datasets

    def __iter__(self):
        return iter(self.server.datasets)

    def __len__(self) -> int:
        return len(self.server.datasets)


class JoinServer:
    """Slot-based batched ApproxJoin engine (caller-driven ``step()`` loop).

    Every batch runs on the device its relations lie on: register or submit
    relations made on the card to serve there.

    ``mesh`` (a ``DeviceMesh`` of ``launch/mesh.py``) serves over its ranks
    from rank 0, joined over ``join_axes`` (all of the mesh's dims by
    default); ranks 1..k-1 run :func:`serve_mesh_worker`, which serves any
    number of mesh servers of rank 0 until :func:`close_mesh_workers`.
    ``bucket_cap`` forces the per-(source, dest) shuffle bucket size;
    ``serve_mode`` is the default merge (``SERVE_MODES``), overridable per
    request.  ``memory_share`` is the share of the card one step's slots
    may plan for (``slot_budget``).
    """

    def __init__(self, *, batch_slots: int = 4,
                 cost_model: Optional[CostModel] = None,
                 sigma_registry: Optional[SigmaRegistry] = None,
                 mesh=None, join_axes: Optional[Sequence[str]] = None,
                 bucket_cap: Optional[int] = None,
                 serve_mode: str = "exact-parity",
                 memory_share: Optional[float] = None,
                 filter_cache_entries: int = 256,
                 sigma_pipeline: bool = True,
                 backlog_slots: Optional[int] = None,
                 latency_samples: int = 4096,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None):
        if serve_mode not in SERVE_MODES:
            raise ValueError(f"unknown serve_mode {serve_mode!r}")
        self.serve_mode = serve_mode
        self.memory_share = memory_share
        self.batch_slots = batch_slots
        # cross-step sigma pipelining: same-query_id error-budget repeats
        # are deferred to the NEXT step so each sees the previous
        # execution's measured sigma (sequential-feedback adaptive sizing);
        # slots freed by a deferral fill with other same-class queries
        self.sigma_pipeline = sigma_pipeline
        # queue length beyond which the scheduler goes deadline-aware:
        # latency-budget queries (deadline = submit + latency_s) are served
        # before error-budget/exact ones (deadline = infinity), FIFO on ties
        self.backlog_slots = 2 * batch_slots if backlog_slots is None \
            else backlog_slots
        self.latency_samples = latency_samples
        self.cost_model = cost_model
        self.sigma = SigmaRegistry() if sigma_registry is None \
            else sigma_registry
        self.queue: list[JoinRequest] = []
        self.datasets: dict[str, list[Relation]] = {}
        self._dataset_fps: dict[str, list[str]] = {}
        self._dataset_overlap: dict[str, float] = {}
        self._stage_keys: set = set()   # the stage keys served (_seen)
        # compiled plans, cached by plan signature: resubmitting a plan shape
        # skips the flatten/validate/cost pass entirely
        self._plan_cache: dict = {}
        self.plans: dict[str, PlanHandle] = {}   # in-flight plan handles
        # LRU of (fingerprint, num_blocks, seed) -> words: bounded so a
        # long-running server with ever-fresh seeds cannot accumulate
        # device-resident filter words without limit
        self._filter_words: OrderedDict = OrderedDict()
        self.filter_cache_entries = filter_cache_entries
        # telemetry: a disabled NULL_TRACER by default — span()/event()/
        # instant() early-return, so the untraced hot path pays one
        # attribute read per site.  The metrics registry is the single
        # backing store of the diagnostics.
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.trace_name = "engine"   # lane/replica label for step spans
        self.diagnostics = ServerDiagnostics(registry=metrics)
        # per-step scratch the tracer consumes (None while tracing is off):
        # the step's stage spans, copied onto each request's lane, and the
        # tensors its byte-reconciliation records read after the step
        self._stage_spans: Optional[list] = None
        self._recon_inputs: Optional[dict] = None
        self._draw_inputs: Optional[tuple] = None
        # completion callback (request -> None), fired by _notify_done for
        # every finished or shed request; the async tier installs its
        # future-resolver here
        self.on_done = None
        self.mesh = mesh
        self.bucket_cap = bucket_cap
        self.join_axes, self.mesh_k, self.mesh_shape = (), 1, ()
        if mesh is not None:
            if dist.get_rank() != 0:
                raise ValueError("a mesh JoinServer runs on rank 0; ranks "
                                 "1..k-1 run serve_mesh_worker")
            axes = tuple(join_axes) if join_axes is not None \
                else tuple(mesh.mesh_dim_names)
            if not all(a in mesh.mesh_dim_names for a in axes):
                raise ValueError(f"join axes {axes} not in the mesh's "
                                 f"{mesh.mesh_dim_names}")
            self.join_axes = axes
            self.mesh_k = mesh_size(mesh, axes)
            self.mesh_shape = tuple((a, mesh.size(mesh.mesh_dim_names.index(
                a))) for a in axes)
            self.diagnostics.per_device_shuffled_bytes = np.zeros(
                self.mesh_k, np.float64)
            self.diagnostics.per_device_dropped_tuples = np.zeros(
                self.mesh_k, np.float64)
            self._ranks = _MeshRank(mesh, axes, sid=next(_SERVER_IDS))
            self._rids = itertools.count()
            self._wkeys = itertools.count()
            # (fp, num_blocks, seed) -> word id of the filter cache's entry
            self._word_ids: dict = {}
            if tracer is not None:
                tracer.tags.setdefault(
                    "mesh", "x".join(str(n) for _, n in self.mesh_shape))
        # rows gathered to rank 0 for the host on a mesh: plans' byte model
        # and snapshots (the kernel classes' are kernel_gather_bytes)
        self.host_gather_bytes = 0.0

    def shutdown(self) -> None:
        """Drop this server's state on every rank of its mesh (a no-op
        without a mesh, or when already stopped); the worker loops go on
        serving the process's other mesh servers."""
        if self.mesh is not None and self._ranks is not None:
            self._ranks.call("stop")
            self._ranks = None

    def mesh_state(self) -> list:
        """Each rank's ``(relation ids, word ids)`` of this server, in rank
        order: what the ranks hold now (a mesh server only)."""
        return self._ranks.call("live")

    # -- admission ----------------------------------------------------------

    def _admit_rels(self, rels: Sequence[Relation],
                    scatter: bool = True) -> list:
        """Bucket relations to their pow2 capacity (at least the mesh size);
        on a mesh, scatter each over the ranks and keep its handle (a
        handle passes through; ``scatter=False`` keeps the rows on rank
        0, as a kernel class serves them)."""
        out = []
        for r in rels:
            if not isinstance(r, ShardedRelation):
                r = bucket_to_pow2(r, minimum=self.mesh_k)
                if self.mesh is not None and scatter:
                    rid = next(self._rids)
                    local = self._ranks.call("rel", r, rid=rid,
                                             capacity=r.capacity)
                    handle = ShardedRelation(rid, local, r.capacity)
                    weakref.finalize(handle, self._ranks.release_rel, rid)
                    r = handle
            out.append(r)
        return out

    def _full_rows(self, rel, memo: dict, kernel: bool = False) -> Relation:
        """A relation's rows in their global order on rank 0: a mesh
        handle's blocks gathered once per ``memo`` (at mesh 1 rank 0's
        block is the relation), metered in ``kernel_gather_bytes`` for a
        kernel class's step, else in ``host_gather_bytes``."""
        if not isinstance(rel, ShardedRelation):
            return rel
        if self.mesh_k == 1:
            return rel.local
        full = memo.get(rel.rid)
        if full is None:
            full = memo[rel.rid] = self._ranks.call("gather", rid=rel.rid)
            # a row crosses as three int32s (gather_fields)
            nbytes = float(12 * rel.capacity * (self.mesh_k - 1)
                           // self.mesh_k)
            if kernel:
                self.diagnostics.kernel_gather_bytes += nbytes
            else:
                self.host_gather_bytes += nbytes
        return full

    def register_dataset(self, name: str, rels: Sequence[Relation]) -> None:
        """Store a named (bucketed) dataset for handle queries.

        Fingerprints are taken here, once — N steps over the dataset build
        its Bloom filter words exactly once per ``(num_blocks, seed)``, and
        re-registering identical relations under a new name reuses the same
        cached words.
        """
        bucketed = [bucket_to_pow2(r, minimum=self.mesh_k) for r in rels]
        self._dataset_fps[name] = [fingerprint(r) for r in bucketed]
        if self.mesh is not None:
            # sizes psum-mode buckets (_planned_cap)
            self._dataset_overlap[name] = bloom_overlap_estimate(bucketed)
        self.datasets[name] = self._admit_rels(bucketed)

    def submit(self, req: JoinRequest) -> JoinRequest:
        if req.rels is None:
            names = req.datasets if req.datasets is not None else (
                [] if req.dataset is None else [req.dataset])
            if not names:
                raise ValueError("JoinRequest needs rels or a dataset handle")
            for name in names:
                if name not in self.datasets:
                    raise ValueError(f"unknown dataset {name!r}")
            req.rels = [r for name in names for r in self.datasets[name]]
            req._fps = [fp for name in names for fp in self._dataset_fps[name]]
        else:
            # inline relations are NOT fingerprinted: hashing every ad-hoc
            # submission would put a device-to-host copy + sha1 of the whole
            # key set on the admission hot path to feed a cache that only
            # pays off for repeated identical key sets — that contract
            # belongs to register_dataset.  Their filter words build per
            # step, uncached.  A kernel request's rows stay on rank 0 of a
            # mesh, where its kernels serve them.
            req.rels = self._admit_rels(req.rels,
                                        scatter=not req.use_kernels)
            req._fps = [None] * len(req.rels)
        if len(req.rels) < 2:
            raise ValueError("join needs at least two relations")
        if req.expr not in EXPRS:
            raise ValueError(f"unknown expr {req.expr!r}")
        if req.agg not in AGGS:
            raise ValueError(f"unknown agg {req.agg!r}")
        if req.max_strata is None:
            # size from the LARGEST input (mirrors approx_join)
            req.max_strata = max(r.capacity for r in req.rels)
        if req.b_max is None:
            # approx_join's b_max=None adaptive grid sizes the draw capacity
            # from data-dependent peak b_i — incompatible with a shape class
            # keyed by its b_max, so refuse rather than silently diverge.
            raise ValueError("JoinServer needs a concrete b_max "
                             f"(e.g. the default {DEFAULT_B_MAX}); the "
                             "adaptive b_max=None grid is driver-side only")
        mode = req.serve_mode or self.serve_mode
        if mode not in SERVE_MODES:
            raise ValueError(f"unknown serve_mode {mode!r}")
        if self.mesh is None or req.use_kernels:
            # the merge only tells mesh pipelines apart: off the mesh (and
            # on the single-device kernel route) there is one pipeline, the
            # exact one
            mode = "exact-parity"
        req._class = shape_class_of(
            req, () if req.use_kernels else self.mesh_shape, mode,
            self._planned_cap(req, mode))
        req._submit_t = time.perf_counter()
        if not req._ingest_t:
            req._ingest_t = req._submit_t
        if self.tracer.enabled:
            if req._span_id is None:
                req._span_id = self.tracer.next_id()
            self.tracer.instant(
                "ingest", cat="admission", tid=self.trace_name,
                ts=req._ingest_t, query_id=req.query_id,
                tenant=tenant_of(req.query_id), qspan=req._span_id)
        self.queue.append(req)
        return req

    # -- query plans --------------------------------------------------------

    def compile_plan(self, plan: Plan) -> CompiledPlan:
        """Compile (or fetch) a plan against this server's datasets.

        Flattening, validation, and the pushdown-vs-binary byte model run
        once per plan signature; repeats are cache hits.  Registering new
        data under a name already baked into a cached plan is fine: the
        compiled form only holds dataset *names*; relations resolve at
        submit time through the normal handle path.
        """
        key = plan.signature()
        compiled = self._plan_cache.get(key)
        if compiled is None:
            with self.tracer.span("plan-compile", cat="plan",
                                  tid=self.trace_name,
                                  nodes=len(plan.nodes)):
                compiled = compile_plan(plan, self.datasets
                                        if self.mesh is None
                                        else _GatheredDatasets(self))
            self._plan_cache[key] = compiled
            self.diagnostics.plan_compiles += 1
        else:
            self.diagnostics.plan_cache_hits += 1
        return compiled

    def submit_plan(self, plan: Plan, *, query_id: str = "plan0",
                    seed: int = 0,
                    use_kernels: Optional[bool] = None) -> PlanHandle:
        """Submit every node of a plan as one engine request each.

        Node requests are ordinary queue entries (query id
        ``'<query_id>/<node>'``), so each node's result is bit-identical to
        a direct ``approx_join`` over its flattened leaf relations with the
        node's own budget: the compiler changes *what* is submitted, never
        how it executes.
        """
        compiled = self.compile_plan(plan)
        handle = PlanHandle(query_id)
        # plan -> node span hierarchy: node spans carry plan/plan_node args
        # and this instant carries the node-reference edges, so trace
        # consumers can nest each node's query span under the nodes that
        # reference it
        self.tracer.instant("plan", cat="plan", tid=self.trace_name,
                            plan=query_id, hierarchy=plan.hierarchy())
        for cn in compiled.nodes:
            node = cn.node
            model = compiled.bytes_model.get(node.name)
            req = JoinRequest(
                datasets=cn.datasets, budget=node.budget, agg=node.agg,
                expr=node.expr, query_id=f"{query_id}/{node.name}",
                seed=seed, fp_rate=node.fp_rate, max_strata=node.max_strata,
                b_max=node.b_max, dedup=node.dedup,
                use_kernels=node.use_kernels if use_kernels is None
                else use_kernels,
                overlap_hint=None if model is None else model["overlap"],
                plan=query_id, plan_node=node.name)
            req._bytes_model = None if model is None else dict(model)
            self.submit(req)
            handle.requests[node.name] = req
        self.plans[query_id] = handle
        return handle

    def _planned_cap(self, req: JoinRequest, mode: str) -> int:
        """Static per-(source, dest) shuffle bucket capacity of a query.

        exact-parity: the lossless worst case (a rank's rows) unless the
        server was built with a ``bucket_cap``.  psum: planned from the
        request's ``overlap_hint`` or its dataset's registration-time
        overlap estimate with 2x slack, pow2-bucketed so near-equal
        estimates share one stage; inline relations plan at overlap 1.0.
        """
        if self.mesh is None or req.use_kernels:
            return 0
        local_n = max(bucket_capacity(r.capacity) for r in req.rels) \
            // self.mesh_k
        if self.bucket_cap:
            return min(self.bucket_cap, local_n)
        if mode != "psum":
            return local_n
        overlap = req.overlap_hint
        if overlap is None:
            overlap = self._dataset_overlap.get(req.dataset, 1.0)
        cap = planned_bucket_cap(local_n, self.mesh_k, overlap)
        return min(bucket_capacity(cap), local_n)

    # -- stage keys + filter-word cache -------------------------------------

    def _seen(self, *key) -> bool:
        """Count a stage key: its first sight in ``compiles`` (returning
        False), every later one in ``cache_hits`` (returning True)."""
        if key in self._stage_keys:
            self.diagnostics.cache_hits += 1
            return True
        self._stage_keys.add(key)
        self.diagnostics.compiles += 1
        return False

    def _words_for(self, rel: Relation, fp: Optional[str], num_blocks: int,
                   seed: int, use_kernels: bool = False) -> torch.Tensor:
        """Per-relation dataset-filter words, built once per (fp, nb, seed).

        ``fp=None`` (inline relations) always builds — no cache entry.
        ``use_kernels`` builds through the CUDA build kernel (its plain
        version for a relation on the CPU); the words are bit-identical
        either way, so kernel and plain queries share one word cache.
        """
        key = (fp, num_blocks, seed)
        if fp is not None:
            words = self._filter_words.get(key)
            if words is not None:
                self._filter_words.move_to_end(key)
                self.diagnostics.filter_cache_hits += 1
                return words
        t0 = time.perf_counter()
        if use_kernels:
            from repro_torch.kernels import ops as kops
            self._seen("fbuild_k", (rel.capacity, num_blocks))
            build = kops.build_filter
        else:
            self._seen("fbuild", (rel.capacity, num_blocks))
            build = bloom.build
        words = build(rel.keys, rel.valid, num_blocks, seed).words
        sync(words.device)
        if fp is not None:
            self._filter_words[key] = words
            while len(self._filter_words) > self.filter_cache_entries:
                self._filter_words.popitem(last=False)
        self.diagnostics.filter_builds += 1
        self.diagnostics.filter_build_s += time.perf_counter() - t0
        return words

    def _mesh_words_for(self, rel, fp: Optional[str], num_blocks: int,
                        seed: int, use_kernels: bool,
                        step_words: list) -> tuple:
        """A mesh server's :meth:`_words_for`: ``(word id, words)``.

        Each rank builds its block's partition filter (through the build
        kernel for a kernel class) and the OR-reduce makes the dataset
        filter on every rank, bit-identical to a single build; rows rank 0
        holds whole (a streaming sub-window's) are scattered for the build
        first.  The exchange puts k - 1 copies of the words on the wire
        (``filter_exchange_bytes_measured``); a cache hit moves nothing,
        except that a mesh class broadcasts words the ranks lack (a
        restored entry) once, under a fresh word id.  An inline relation's
        words (``fp=None``) live for the step: their id goes on
        ``step_words``.
        """
        key = (fp, num_blocks, seed)
        if fp is not None and key in self._filter_words:
            self._filter_words.move_to_end(key)
            self.diagnostics.filter_cache_hits += 1
            words = self._filter_words[key]
            wkey = self._word_ids.get(key)
            if wkey is None and not use_kernels:
                wkey = self._word_ids[key] = self._push_words(words)
            return wkey, words
        t0 = time.perf_counter()
        self._seen("fbuild", (rel.capacity, num_blocks, self.mesh_shape,
                              use_kernels))
        # a handle lives through its build (the ranks drop a scattered
        # sub-window's block at the next header once it is gone)
        rel = self._admit_rels([rel])[0]
        wkey = next(self._wkeys)
        words = self._ranks.call("fbuild", num_blocks=num_blocks,
                                 kernels=use_kernels, rid=rel.rid, wkey=wkey,
                                 seed=seed)
        sync(words.device)
        self.diagnostics.filter_exchange_bytes_measured += float(
            words.numel() * words.element_size() * (self.mesh_k - 1))
        if fp is None:
            step_words.append(wkey)
        else:
            self._filter_words[key] = words
            self._word_ids[key] = wkey
            while len(self._filter_words) > self.filter_cache_entries:
                self._evict_words(next(iter(self._filter_words)))
        self.diagnostics.filter_builds += 1
        self.diagnostics.filter_build_s += time.perf_counter() - t0
        return wkey, words

    def _push_words(self, words: torch.Tensor) -> int:
        """Rank 0's ``words`` on every rank under a fresh word id."""
        wkey = next(self._wkeys)
        self._ranks.call("words", words, wkey=wkey, shape=tuple(words.shape))
        return wkey

    def _or_words_on_ranks(self, wkeys: Sequence[int]) -> int:
        """The OR of the words every rank holds under ``wkeys``, kept on the
        ranks under a fresh word id (a window's filter: no bytes move)."""
        wkey = next(self._wkeys)
        self._ranks.call("wor", srcs=list(wkeys), wkey=wkey)
        return wkey

    def _release_request_words(self, req: JoinRequest) -> None:
        """Let the ranks drop a request's ``_word_keys`` (served or shed)."""
        if self.mesh is not None and req._word_keys:
            for wkey in req._word_keys:
                self._ranks.release_words(wkey)
        req._word_keys = None

    def _evict_words(self, key) -> bool:
        """Drop a filter-cache entry, and on a mesh its words on the ranks;
        False when it was not cached."""
        if self._filter_words.pop(key, None) is None:
            return False
        if self.mesh is not None:
            wkey = self._word_ids.pop(key, None)
            if wkey is not None and self._ranks is not None:
                self._ranks.release_words(wkey)
        return True

    # -- engine -------------------------------------------------------------

    def _deadline(self, req: JoinRequest) -> float:
        """Absolute serve-by time: latency budgets are deadlines, error and
        exact budgets are best-effort (infinite deadline)."""
        if req.budget.latency_s is None:
            return float("inf")
        return req._ingest_t + req.budget.latency_s

    def _slot_cap(self, cls: ShapeClass, device) -> int:
        """Batch width cap for one step of this shape class on ``device``.

        A kernel class's step holds :func:`slot_bytes` per slot, pad slots
        included, so the width is the largest power of two whose slots fit
        :func:`slot_budget` (at least 1, at most ``batch_slots``).  The
        plain route is the reference route and keeps ``batch_slots``.
        """
        if not cls.use_kernels:
            return self.batch_slots
        cap = min(slot_budget(device, self.memory_share) // slot_bytes(cls),
                  self.batch_slots)
        cap = max(cap, 1)
        return 1 << (cap.bit_length() - 1)          # floor to pow2

    def _take_batch(self) -> tuple:
        """Pick the next step's shape class and batch.

        FIFO until the queue backs up past ``backlog_slots``; then
        deadline-aware — the class of the tightest-deadline request is
        served, and within the class candidates are ordered by deadline
        (stable, so all-error queues stay FIFO).  With ``sigma_pipeline``,
        at most one error-budget request per ``query_id`` joins a batch:
        the repeat is deferred one step so it sees this step's measured
        sigma (sequential-feedback adaptive sizing), and its slot fills
        with the next same-class query instead.
        """
        backlog = len(self.queue) > self.backlog_slots
        if backlog:
            head = min(self.queue, key=self._deadline)
            if head._class != self.queue[0]._class:
                self.diagnostics.deadline_promotions += 1
            cls = head._class
        else:
            cls = self.queue[0]._class
        candidates = [r for r in self.queue if r._class == cls]
        if backlog:
            candidates.sort(key=self._deadline)   # stable: FIFO on ties
        batch, seen_ids = [], set()
        slots = self._slot_cap(cls, _rows_of(candidates[0].rels[0]).device)
        for r in candidates:
            if len(batch) == slots:
                break
            if (self.sigma_pipeline and r.budget.error is not None
                    and r.query_id in seen_ids):
                self.diagnostics.sigma_deferrals += 1
                continue
            batch.append(r)
            seen_ids.add(r.query_id)
        taken = set(map(id, batch))
        self.queue = [r for r in self.queue if id(r) not in taken]
        return cls, batch

    def step(self) -> int:
        """Serve one batch of same-shape-class queries; returns batch size."""
        if not self.queue:
            return 0
        tr, lane = self.tracer, self.trace_name
        with tr.span("batch-formation", cat="batch", tid=lane) as sp:
            cls, batch = self._take_batch()
            path = self._path_of(cls)
            sp.set(batch=len(batch), path=path)
        t_dispatch = time.perf_counter()
        self.diagnostics.steps += 1
        self.diagnostics.max_batch = max(self.diagnostics.max_batch,
                                         len(batch))
        with tr.span("step", cat="serve", tid=lane, batch=len(batch),
                     path=path):
            self._run_batch(cls, batch)
        t_done = time.perf_counter()
        for req in batch:
            req._dispatch_t = t_dispatch
            req._complete_t = t_done
            req.queue_latency_s = t_dispatch - req._ingest_t
            req.e2e_latency_s = t_done - req._ingest_t
            req.done = True
            self.diagnostics.note_latency(
                tenant_of(req.query_id), req.queue_latency_s,
                req.e2e_latency_s, self.latency_samples)
            self.diagnostics.queries += 1
            d = req.result.diagnostics
            self.diagnostics.shuffled_bytes_saved += float(
                d.shuffled_bytes_repartition - d.shuffled_bytes_filtered)
            self._notify_done(req)
        if tr.enabled:
            self._trace_step(cls, batch)
        self._stage_spans = self._recon_inputs = self._draw_inputs = None
        return len(batch)

    def _path_of(self, cls: ShapeClass) -> str:
        """Serving-path tag for trace/reconciliation grouping."""
        if cls.use_kernels:
            return "kernel"
        if cls.mesh:
            return f"mesh{self.mesh_k}/{cls.serve_mode}"
        return "single"

    def _trace_step(self, cls: ShapeClass, batch: list[JoinRequest]) -> None:
        """After a traced step (its engine-lane spans were recorded live):
        a complete per-query span tree (query -> queued/execute ->
        prepare/sample|exact -> complete) on a lane per request instance,
        its stage spans copied from the engine's, and the per-query byte
        reconciliation records, computed here, off the step's clock.

        A step that sampled also gets a ``draws`` instant on the engine
        lane at its ``decide`` span's start, counted from the sampler's own
        ``n_sampled`` over the sampled slots' joinable strata: ``draws``
        (edges drawn), ``full`` (strata drawn as often as they have edges)
        and ``joinable``."""
        tr, path = self.tracer, self._path_of(cls)
        stages = {sp.name: sp for sp in self._stage_spans or ()}
        recs = self._recon_records(cls, batch, **self._recon_inputs) \
            if self._recon_inputs is not None else {}
        if self._draw_inputs is not None:
            ts, pop, n = self._draw_inputs
            n = n.cpu().numpy()
            ok = pop > 0
            tr.instant("draws", cat="host", tid=self.trace_name, ts=ts,
                       draws=int(n[ok].astype(np.int64).sum()),
                       full=int((n >= pop)[ok].sum()),
                       joinable=int(ok.sum()))
        for req in batch:
            tid = f"q:{req.query_id}#{req._span_id}"
            base = dict(query_id=req.query_id, qspan=req._span_id, path=path)
            if req.stream is not None:
                base.update(stream=req.stream, window=req.window_id)
            if req.plan is not None:
                base.update(plan=req.plan, plan_node=req.plan_node)
            tr.event("query", req._ingest_t,
                     req._complete_t - req._ingest_t, cat="query", tid=tid,
                     seed=req.seed, tenant=tenant_of(req.query_id), **base)
            tr.event("queued", req._ingest_t,
                     req._dispatch_t - req._ingest_t, cat="query", tid=tid,
                     **base)
            tr.event("execute", req._dispatch_t,
                     req._complete_t - req._dispatch_t, cat="query", tid=tid,
                     **base)
            for sp in stages.values():
                tr.event(sp.name, sp.t0, sp.dur, cat="stage", tid=tid,
                         **{**base, **sp.args})
            rec = recs.get(id(req))
            if rec is not None:
                tr.note_recon(rec)
                # zero-duration sub-phase markers carrying the byte pairs
                # (the filter exchange and the shuffle are modeled costs of
                # the prepare stage, so they mark, not span)
                prep = stages.get("prepare")
                p_ts, p_dur = (req._dispatch_t, 0.0) if prep is None \
                    else (prep.t0, prep.dur)
                pairs = {p["name"]: p for p in rec["pairs"]}
                fe = pairs.get("filter_exchange_bytes")
                if fe is not None:
                    tr.event("filter-exchange", p_ts + p_dur, 0.0,
                             cat="stage", tid=tid, modeled=fe["modeled"],
                             **base)
                sh = pairs.get("live_tuple_bytes")
                if sh is not None:
                    tr.event("shuffle", p_ts + p_dur, 0.0, cat="stage",
                             tid=tid, modeled=sh["modeled"],
                             measured=sh["measured"], **base)
            tr.instant("complete", cat="query", tid=tid,
                       ts=req._complete_t, **base)

    def _notify_done(self, req: JoinRequest) -> None:
        """Completion hook — fires once per finished OR shed request.  The
        async tier resolves the request's per-query future here; the hook
        runs after the result (or the shed flag) is fully populated."""
        if self.on_done is not None:
            self.on_done(req)
        if req.plan is not None:
            handle = self.plans.get(req.plan)
            if handle is not None and handle.done:
                del self.plans[req.plan]

    def run(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if self.step() == 0:
                break

    # -- crash safety: snapshot / restore -----------------------------------
    #
    # A snapshot is ``(flat tensors, meta)``: every device-resident piece of
    # engine state as a flat {key: tensor} dict (what runtime/checkpoint.py
    # serializes, one .npy + checksum per key) plus a JSON-able meta dict
    # carrying the host-side structure (dataset names/fingerprints, the
    # sigma table, queue descriptors, scalar counters), in the JAX
    # package's layout.  Keys are index-based (``ds/0/1/keys``) so
    # user-chosen names never have to round-trip through a file name.  NOT
    # captured: the stage keys served (seen afresh on the restoring server,
    # a warmup cost, not state) and in-flight latency timestamps (latency across a
    # crash is ill-defined; restored requests re-stamp at restore
    # admission).

    # scalar diagnostics that survive a crash (cumulative counters; the
    # latency rings restart empty)
    _DIAG_SCALARS = _DIAG_SCALAR_FIELDS

    @staticmethod
    def _req_meta(req: JoinRequest) -> dict:
        return {"dataset": req.dataset,
                "datasets": None if req.datasets is None
                else list(req.datasets),
                "plan": req.plan, "plan_node": req.plan_node,
                "budget": list(req.budget),
                "agg": req.agg, "expr": req.expr, "query_id": req.query_id,
                "seed": req.seed, "fp_rate": req.fp_rate,
                "max_strata": req.max_strata, "b_max": req.b_max,
                "dedup": req.dedup, "use_kernels": req.use_kernels,
                "serve_mode": req.serve_mode, "filter_seed": req.filter_seed,
                "overlap_hint": req.overlap_hint, "stream": req.stream,
                "window_id": req.window_id,
                "n_rels": len(req.rels) if req.rels is not None else 0,
                "n_words": 0 if req._words is None else len(req._words)}

    @staticmethod
    def _rel_arrays(flat: dict, prefix: str, r: Relation) -> None:
        flat[f"{prefix}/keys"] = r.keys
        flat[f"{prefix}/values"] = r.values
        flat[f"{prefix}/valid"] = r.valid

    def _rel_restore(self, flat: dict, prefix: str, device,
                     scatter: bool = True):
        """A snapshot's relation (tensors, or the numpy arrays a checkpoint
        loads) on ``device``; on a mesh scattered over this server's ranks
        (unless ``scatter`` is False: rows a kernel class or a streaming
        session keeps on rank 0)."""
        r = relation(flat[f"{prefix}/keys"], flat[f"{prefix}/values"],
                     flat[f"{prefix}/valid"], device=device)
        return self._admit_rels([r], scatter)[0]

    def snapshot_state(self) -> tuple[dict, dict]:
        """Capture the full serving state as ``(flat tensors, meta)``.

        Feed the pair to :func:`repro_torch.runtime.checkpoint.save_checkpoint`
        (``tree=flat``, ``extra=meta``); the inverse is ``load_checkpoint``
        + :meth:`restore_state`.  The capture is synchronous with respect to
        engine mutation: call between steps (the async tier snapshots on
        its loop thread under the engine lock).  On a mesh every relation
        is gathered to rank 0 in its global row order, so the snapshot is
        the one a single-device server of the same state takes."""
        flat: dict = {}
        meta: dict = {}
        ds_meta = []
        memo: dict = {}
        for di, (name, rels) in enumerate(self.datasets.items()):
            for i, r in enumerate(rels):
                self._rel_arrays(flat, f"ds/{di}/{i}",
                                 self._full_rows(r, memo))
            # overlap: a mesh engine's registration-time estimate
            ds_meta.append({"name": name, "n": len(rels),
                            "fps": self._dataset_fps[name],
                            "overlap": self._dataset_overlap.get(name)})
        meta["datasets"] = ds_meta
        fw_keys = []
        for j, (key, words) in enumerate(self._filter_words.items()):
            fw_keys.append(list(key))            # [fp, num_blocks, seed]
            flat[f"fw/{j}"] = words
        meta["filter_cache"] = fw_keys           # in LRU order
        meta["sigma"] = {q: {str(k): float(v) for k, v in t.items()}
                         for q, t in self.sigma.table.items()}
        q_meta = []
        for j, req in enumerate(self.queue):
            # handle requests (single- or multi-dataset) need no arrays: the
            # datasets themselves are in the snapshot and resolve by name
            if req.dataset is None and req.datasets is None:
                for i, r in enumerate(req.rels):
                    self._rel_arrays(flat, f"q/{j}/rels/{i}",
                                     self._full_rows(r, memo))
            if req._words is not None:           # pre-merged window words
                for i, w in enumerate(req._words):
                    flat[f"q/{j}/words/{i}"] = w
            q_meta.append(self._req_meta(req))
        meta["queue"] = q_meta
        meta["diag"] = {f: getattr(self.diagnostics, f)
                        for f in self._DIAG_SCALARS}
        # span-id sequence: the successor adopting this snapshot must never
        # reuse this engine's span ids (Tracer.adopt max-merges)
        meta["telemetry"] = self.tracer.state()
        return flat, meta

    def restore_state(self, flat: dict, meta: dict,
                      device=None) -> list[JoinRequest]:
        """Merge a snapshot into this engine; returns the re-queued requests.

        Every restored tensor lands on ``device``: the card unless the
        caller asks for the CPU (the engine has no device of its own; a
        batch runs where its relations lie).  Merge semantics (not
        replace): restoring into a fresh engine is a plain restore,
        restoring into a live one ADOPTS the snapshot's tenants, the
        failover path, where a successor absorbs a dead replica's datasets,
        filter words, sigma entries (overwritten per query_id, continuing
        each sigma sequence exactly) and queued requests (appended in saved
        order, so same-``query_id`` FIFO, the only order sigma feedback
        observes, is preserved).  Served-but-undrained results are NOT part
        of a snapshot: their futures resolved at completion time, before
        any crash this snapshot survives.

        On a mesh, whatever mesh (or none) took the snapshot, every
        relation is scattered over this server's ranks (a kernel request's
        stays on rank 0) and cached filter words reach the ranks under
        fresh word ids when a mesh class first needs them."""
        device = torch.device("cuda" if device is None else device)
        for di, d in enumerate(meta.get("datasets", [])):
            rels = [self._rel_restore(flat, f"ds/{di}/{i}", device, False)
                    for i in range(d["n"])]
            if self.mesh is not None:
                overlap = d.get("overlap")
                self._dataset_overlap[d["name"]] = overlap \
                    if overlap is not None else bloom_overlap_estimate(
                        [bucket_to_pow2(r, minimum=self.mesh_k)
                         for r in rels])
            self.datasets[d["name"]] = self._admit_rels(rels)
            self._dataset_fps[d["name"]] = list(d["fps"])
        for j, key in enumerate(meta.get("filter_cache", [])):
            fp, num_blocks, seed = key
            self._filter_words[(fp, int(num_blocks), int(seed))] = \
                torch.as_tensor(flat[f"fw/{j}"], device=device)
        while len(self._filter_words) > self.filter_cache_entries:
            self._evict_words(next(iter(self._filter_words)))
        for q, t in meta.get("sigma", {}).items():
            self.sigma.table[q] = {int(k): float(v) for k, v in t.items()}
        restored = []
        for j, m in enumerate(meta.get("queue", [])):
            rels = None
            if m["dataset"] is None and not m.get("datasets"):
                rels = [self._rel_restore(flat, f"q/{j}/rels/{i}", device,
                                          not m["use_kernels"])
                        for i in range(m["n_rels"])]
            req = JoinRequest(
                rels=rels, dataset=m["dataset"], datasets=m.get("datasets"),
                budget=QueryBudget(*m["budget"]), agg=m["agg"],
                expr=m["expr"], query_id=m["query_id"], seed=m["seed"],
                fp_rate=m["fp_rate"], max_strata=m["max_strata"],
                b_max=m["b_max"], dedup=m["dedup"],
                use_kernels=m["use_kernels"], serve_mode=m.get("serve_mode"),
                filter_seed=m["filter_seed"],
                overlap_hint=m["overlap_hint"], stream=m["stream"],
                window_id=m["window_id"], plan=m.get("plan"),
                plan_node=m.get("plan_node"))
            if m["n_words"]:
                req._words = [torch.as_tensor(flat[f"q/{j}/words/{i}"],
                                              device=device)
                              for i in range(m["n_words"])]
            self.submit(req)
            restored.append(req)
            if req.plan is not None:
                # regroup plan-node requests into a live handle so the
                # successor tracks (and completes) the adopted plan whole
                handle = self.plans.setdefault(req.plan,
                                               PlanHandle(req.plan))
                handle.requests[req.plan_node] = req
        for f, v in meta.get("diag", {}).items():
            if f == "max_batch":
                self.diagnostics.max_batch = max(self.diagnostics.max_batch,
                                                 v)
            else:
                setattr(self.diagnostics, f,
                        getattr(self.diagnostics, f) + v)
        tel = meta.get("telemetry")
        if tel and self.tracer is not NULL_TRACER:
            self.tracer.adopt(tel)
        return restored

    # -- execution ----------------------------------------------------------

    def _batch_inputs(self, cls: ShapeClass, batch: list[JoinRequest]):
        """Pad to the pow2 batch bucket; stack relations, words and seeds.

        Seeds come back as int64 ``[B]`` tensors on the batch's device,
        each wrapped mod 2^32, as the kernels take them.  A mesh class's
        step names its relations and filters by id instead (every rank
        stacks its own blocks); a kernel class on a mesh gathers its rows
        to rank 0 and stacks them there."""
        B = bucket_capacity(len(batch))
        pad = B - len(batch)
        reqs = batch + [batch[-1]] * pad              # pad slots (discarded)
        # rows before the seeds: the seeds' copies wait for the row stacks,
        # so that wait stays in batch-inputs, not in the prepare span
        if cls.mesh:
            rels_b = [[r.rels[s].rid for s in range(cls.n_inputs)]
                      for r in reqs]
        else:
            memo: dict = {}
            rows = [[self._full_rows(r.rels[s], memo, kernel=True)
                     for r in reqs] for s in range(cls.n_inputs)]
            rels_b = [Relation(*(torch.stack([rel[f] for rel in side])
                                 for f in range(3))) for side in rows]
        dev = _rows_of(batch[0].rels[0]).device
        fs = [r.seed if r.filter_seed is None else r.filter_seed
              for r in reqs]
        seeds = torch.tensor([r.seed & MASK for r in reqs], device=dev)
        fseeds = torch.tensor([f & MASK for f in fs], device=dev)
        num_blocks = bloom.num_blocks_for(max(cls.caps), cls.fp_rate)
        # words are fetched per REAL request only (pad slots replay the last
        # request's words) so the build/reuse counters stay honest
        self._step_words = []            # dropped once the step is done
        per_req = [self._request_words(cls, r, fs[i], num_blocks)
                   for i, r in enumerate(batch)]
        if cls.mesh:
            wkeys = [[w for w, _ in ws] for ws in per_req]
            return B, rels_b, wkeys + wkeys[-1:] * pad, seeds, fseeds, \
                num_blocks
        words = [torch.stack([w for _, w in ws]) for ws in per_req]
        return B, rels_b, torch.stack(words + words[-1:] * pad), seeds, \
            fseeds, num_blocks

    def _request_words(self, cls: ShapeClass, r: JoinRequest, fseed: int,
                       num_blocks: int) -> list:
        """A real request's ``(word id, words)`` per input: its prebuilt
        words, or the per-dataset cache's.  A mesh class takes prebuilt
        words by their ids on the ranks, or broadcasts them for the step."""
        n = cls.n_inputs
        if r._words is None:
            if self.mesh is None:
                return [(None, self._words_for(r.rels[s], r._fps[s],
                                               num_blocks, fseed,
                                               cls.use_kernels))
                        for s in range(n)]
            return [self._mesh_words_for(r.rels[s], r._fps[s], num_blocks,
                                         fseed, cls.use_kernels,
                                         self._step_words)
                    for s in range(n)]
        if len(r._words) != n:
            raise ValueError(f"{len(r._words)} prebuilt filters for {n} "
                             "inputs")
        if not cls.mesh:
            keys = [None] * n
        elif r._word_keys is not None:
            keys, r._word_keys = r._word_keys, None   # released with the step
            self._step_words += keys
        else:
            keys = [self._push_words(w) for w in r._words]
            self._step_words += keys
        return list(zip(keys, r._words))

    def _decide_b_rows(self, batch, B, totals, skeys, strata_slice,
                       d_filter):
        """Host decisions: exact-affordable?  b_i from budget + sigma.

        ``totals`` is each slot's exact total population (what a latency
        budget weighs, as :func:`approx_join` does); ``skeys`` the strata
        keys on the host, read by error budgets only (``None`` in a step of
        exact requests alone)."""
        sampled_idx, b_rows = [], []
        zeros_b = torch.zeros_like(strata_slice(0).keys, dtype=torch.float32)
        for i, req in enumerate(batch):
            budget = req.budget
            exact_ok = budget.is_exact or (
                budget.latency_s is not None and self.cost_model is not None
                and float(self.cost_model.beta_compute) * float(totals[i])
                + self.cost_model.epsilon + d_filter <= budget.latency_s
                and budget.error is None)
            if exact_ok:
                b_rows.append(zeros_b)
                continue
            sigma = None
            if budget.error is not None and self.sigma.has(req.query_id):
                with self.tracer.span(
                        "sigma-lookup", cat="host", tid=self.trace_name,
                        strata=len(skeys[i]), query_id=req.query_id,
                        qspan=req._span_id) as sp:
                    sigma, hits = self.sigma.find(req.query_id, skeys[i])
                    if self.tracer.enabled:
                        sp.set(hits=hits)
            b_rows.append(decide_sample_sizes(
                budget, strata_slice(i), self.cost_model, d_filter, sigma,
                budget.confidence))
            sampled_idx.append(i)
        exact_idx = [i for i in range(len(batch)) if i not in sampled_idx]
        b_rows += [zeros_b] * (B - len(batch))
        return sampled_idx, exact_idx, b_rows

    def _finish_batch(self, batch, *, strata_slice, live_counts, total_counts,
                      fbytes, d_filter, exact_idx, e_est, e_cnt,
                      value, err, cnt, dof, stats, skeys, dropped=None):
        """Per-query results + sigma feedback (``dropped``: each query's
        rows past the mesh's shuffle buckets)."""
        n = batch[0]._class.n_inputs
        for i, req in enumerate(batch):
            strata_i = strata_slice(i)
            live_i, tot_i = live_counts[i], total_counts[i]
            diag = dict(
                dist_dropped_tuples=0.0 if dropped is None
                else float(dropped[i]),
                total_counts=tot_i, live_counts=live_i,
                overlap_fraction=live_i.sum()
                / torch.clamp(tot_i.sum(), min=1),
                filter_bytes=fbytes,
                shuffled_bytes_filtered=live_i.sum() * TUPLE_BYTES
                + filter_exchange_bytes(n, fbytes),
                shuffled_bytes_repartition=tot_i.sum() * TUPLE_BYTES,
                num_strata=strata_i.num_strata,
                strata_overflow=strata_i.overflow,
                total_population=strata_i.population.sum(),
                d_filter_s=d_filter)
            if i in exact_idx:
                zero = torch.zeros((), device=e_est.device)
                req.result = JoinResult(
                    e_est[i], zero, e_cnt[i], zero,
                    JoinDiagnostics(sample_draws=zero, sampled=False, **diag),
                    strata=strata_i)
                self.diagnostics.exact_queries += 1
                continue
            stats_i = _slot(stats, i)
            req.result = JoinResult(
                value[i], err[i], cnt[i], dof[i],
                JoinDiagnostics(sample_draws=stats_i.n_sampled.sum(),
                                sampled=True, **diag),
                stats=stats_i, strata=strata_i)
            sig, ok = self._to_host(
                "sigma", measured_sigma(stats_i),
                stats_i.valid & (stats_i.n_sampled > 1))
            with self.tracer.span(
                    "sigma-update", cat="host", tid=self.trace_name,
                    strata=len(skeys[i]), query_id=req.query_id,
                    qspan=req._span_id) as sp:
                new = self.sigma.update(req.query_id, skeys[i], sig, ok)
                if self.tracer.enabled:
                    sp.set(kept=int(ok.sum()), new=new)
            self.diagnostics.sampled_queries += 1

    def _to_host(self, what: str, *tensors) -> list:
        """The tensors copied to the host (numpy arrays), under one
        ``to-host`` span of their bytes."""
        with self.tracer.span("to-host", cat="host", tid=self.trace_name,
                              bytes=sum(t.nbytes for t in tensors),
                              what=what):
            return [t.cpu().numpy() for t in tensors]

    def _run_batch(self, cls: ShapeClass, batch: list[JoinRequest]) -> None:
        """One engine step: one call per stage for the whole batch.

        A kernel class the sampler kernel does not take samples with plain
        torch (approx_join's own use_kernels composition).  A mesh class's
        stages broadcast their header and run on every rank, on the
        per-rank state the prepare left there.

        Traced, the step's parts are live spans on the engine lane, inside
        its ``step``: ``batch-inputs``, ``compile`` (a fresh prepare's
        warm-up), ``prepare``, ``to-host`` (each copy to the host: every
        slot's total population, 8 bytes a slot; the strata populations and
        keys only in a step with a request that is not exact; on a mesh the
        bucket overflow and the meters), ``decide`` (with a ``sigma-lookup``
        a registry lookup), ``sample`` / ``exact``, and ``finish`` (with
        each sampled request's ``to-host`` of its sigmas and a
        ``sigma-update``)."""
        tr, lane, path = self.tracer, self.trace_name, self._path_of(cls)
        with tr.span("batch-inputs", cat="host", tid=lane) as sp:
            B, rels_b, words_b, seeds, fseeds, num_blocks = \
                self._batch_inputs(cls, batch)
            sp.set(slots=B, real=len(batch))
        n_real, device = len(batch), seeds.device
        specs = None
        if cls.mesh:         # the per-rank stages, as _mesh_stage builds them
            cap = cls.bucket_cap or max(cls.caps) // self.mesh_k
            merge = "psum" if cls.serve_mode == "psum" else "gather"
            specs = dict(prepare=("prepare", cls.n_inputs, num_blocks,
                                  cls.max_strata, cap, merge),
                         sample=("sample", merge, cls.b_max, cls.agg,
                                 cls.dedup, cls.confidence, cls.expr),
                         exact=("exact", merge, cls.agg, cls.expr))
        # the step's stage spans, for the requests' lanes ([] only while
        # tracing, so the untraced path waits for the device no more than it
        # must)
        stages = [] if tr.enabled else None

        def stage(name: str, **args):
            sp = tr.span(name, cat="stage", tid=lane, path=path, **args)
            if stages is not None:
                stages.append(sp)
            return sp

        def prepare():
            if specs is not None:
                return self._ranks.call(
                    "prepare", spec=specs["prepare"], slots=rels_b,
                    wkeys=words_b, fseeds=fseeds.tolist(), n_real=n_real)
            if cls.use_kernels:
                return prepare_stage_kernels_batched(
                    rels_b, words_b, cls.max_strata, fseeds, n_real=n_real)
            return _prepare_slots(cls, rels_b, words_b, fseeds, n_real)

        if not self._seen("prepare", cls, B) and not cls.mesh:
            # warm the stage off the clock: d_filter feeds the latency cost
            # function (§3.2), which models repeated query execution —
            # charging the kernels' load and the first allocations would
            # skew every latency budget on the first batch of a class.  A
            # mesh class loads no kernel, and its warm-up would shuffle
            # every slot's rows once more
            with stage("compile", stage="prepare"):
                prepare()
                sync(device)
        with stage("prepare") as sp:
            t0 = time.perf_counter()
            prep = prepare()
            sync(device)
            d_filter = time.perf_counter() - t0
            if tr.enabled and specs is None:
                sp.set(rows=n_real * sum(r.capacity for r in rels_b),
                       sorted=int(prep.sorted_rows[:n_real].sum()))
        self.diagnostics.filter_s += d_filter

        # an exact request reads nothing of its strata on the host: only a
        # latency budget, the registry and the draws meter read the [B, S]
        # populations and keys
        totals, = self._to_host("totals", prep.strata.population.sum(-1))
        population = skeys = None
        if not all(r.budget.is_exact for r in batch):
            population, = self._to_host("population", prep.population)
            skeys, = self._to_host("strata-keys", prep.strata.keys)

        def slice_i(i):
            return _slot(prep.strata, i)

        with tr.span("decide", cat="host", tid=lane) as decide:
            sampled_idx, exact_idx, b_rows = self._decide_b_rows(
                batch, B, totals, skeys, slice_i, d_filter)
            decide.set(sampled=len(sampled_idx), exact=len(exact_idx))

        # -- one call per stage, whole batch --------------------------------
        value = err = cnt = dof = stats = e_est = e_cnt = None
        if sampled_idx:
            self._seen("sample", cls, B)
            with stage("sample", queries=len(sampled_idx)):
                b, sseeds = torch.stack(b_rows), (seeds + 1) & MASK
                if specs is not None:
                    out = self._ranks.call("sample", b, spec=specs["sample"],
                                           seeds=sseeds.tolist(),
                                           n_real=n_real)
                elif kernel_sampler(cls):
                    out = sample_stage_kernels_batched(
                        prep.sorted_rels, prep.strata, b, cls.b_max, sseeds,
                        agg=cls.agg, confidence=cls.confidence,
                        expr=cls.expr)
                else:
                    out = _sample_slots(cls, prep.sorted_rels, prep.strata,
                                        b, sseeds, n_real)
                value, err, cnt, dof, stats = out
                if stages is not None:
                    sync(device)
        if exact_idx:
            self._seen("exact", cls, B)
            with stage("exact", queries=len(exact_idx)):
                if specs is not None:
                    e_est, e_cnt = self._ranks.call(
                        "exact", spec=specs["exact"], n_real=n_real)
                else:
                    e_est, e_cnt = _exact_slots(cls, prep.sorted_rels,
                                                prep.strata, n_real)
                if stages is not None:
                    sync(device)

        # kernel classes run the single-device pipeline even on a mesh
        # server (a plain PrepareOut: no shuffle buckets, nothing dropped)
        meshless = self.mesh is None or cls.use_kernels
        if cls.use_kernels:
            self.diagnostics.kernel_queries += len(batch)
        dropped = None if meshless else self._to_host(
            "bucket-overflow", prep.bucket_overflow)[0].astype(np.float64)
        fbytes = num_blocks * bloom.WORDS_PER_BLOCK * 4
        with tr.span("finish", cat="host", tid=lane, requests=len(batch)):
            self._finish_batch(
                batch, strata_slice=slice_i, live_counts=prep.live_counts,
                total_counts=prep.total_counts, fbytes=fbytes,
                d_filter=d_filter, exact_idx=exact_idx, e_est=e_est,
                e_cnt=e_cnt, value=value, err=err, cnt=cnt, dof=dof,
                stats=stats, skeys=skeys, dropped=dropped)
        self.diagnostics.filter_exchange_bytes_model += \
            len(batch) * float(filter_exchange_bytes(cls.n_inputs, fbytes))
        if not meshless:
            # the measured shuffle volume and the capacity plan's drops
            # (always 0 under the lossless exact-parity default), pad slots
            # excluded
            d = self.diagnostics
            tup, dev_bytes, dev_dropped = self._to_host(
                "meters", prep.shuffled_tuple_bytes[:n_real].sum(),
                prep.device_shuffled_bytes[:n_real].sum(0),
                prep.device_dropped[:n_real].sum(0))
            d.dist_shuffled_tuple_bytes += float(tup)
            d.per_device_shuffled_bytes = d.per_device_shuffled_bytes \
                + dev_bytes
            d.dist_dropped_tuples += float(dropped[:n_real].sum())
            d.per_device_dropped_tuples = d.per_device_dropped_tuples \
                + dev_dropped
            d.dist_wire_bytes_model += n_real * self._wire_bytes_model(cls)
        for wkey in self._step_words:           # none off a mesh
            self._ranks.release_words(wkey)
        if stages is not None:
            self._stage_spans = stages
            # the tensors the reconciliation records read, after the step
            self._recon_inputs = dict(
                live=prep.live_counts[:n_real], fbytes=fbytes,
                tup=None if meshless else prep.shuffled_tuple_bytes[:n_real],
                dev=None if meshless
                else prep.device_shuffled_bytes[:n_real])
            # the sampled slots' populations and draws, counted after the step
            self._draw_inputs = None if not sampled_idx else (
                decide.t0, population[sampled_idx],
                stats.n_sampled[sampled_idx])

    def _wire_bytes_model(self, cls: ShapeClass) -> float:
        """Static per-rank collective bytes for ONE query through the mesh
        pipeline (buffers, not live tuples: what a static-shape dataflow
        puts on the wire; the serve-time restatement of Eq. 24)."""
        k = self.mesh_k
        if k <= 1:
            return 0.0
        cap = cls.bucket_cap or max(cls.caps) // k
        n = cls.n_inputs
        a2a = n * (k - 1) * cap * TUPLE_BYTES     # key shuffle send buffers
        if cls.serve_mode == "psum":
            merge = len(SumParts._fields) * 4 * (k - 1)
        else:
            # gather merge: all_gathers of [S] slot arrays, strata keys +
            # per-side counts (prepare), 7 stat fields (sample), per-side
            # sums (exact)
            merge = ((1 + n) + 7 + n) * cls.max_strata * 4 * (k - 1)
        return float(a2a + merge)

    def _recon_records(self, cls: ShapeClass, batch: list[JoinRequest], *,
                       live, fbytes: int, tup=None, dev=None) -> dict:
        """Per-query byte-reconciliation records (traced steps only, after
        the step): each modeled cost paired with its metered counterpart,
        keyed by request identity for ``_trace_step``.  ``live``, ``tup``
        and ``dev`` are the step's live counts and, on a mesh, its shuffled
        tuple and per-device bytes, real slots only.  A single-device or
        kernel query moves no tuples over a wire, so its pairs are
        unmetered."""
        k = self.mesh_k
        meshless = tup is None
        live = live.cpu().numpy()
        if not meshless:
            tup, dev = tup.cpu().numpy(), dev.cpu().numpy()
        path, wire = self._path_of(cls), self._wire_bytes_model(cls)
        fe_model = float(filter_exchange_bytes(cls.n_inputs, fbytes))
        out = {}
        for i, req in enumerate(batch):
            # live-tuple bytes: §3.1's filtered-shuffle volume against the
            # tuple bytes the mesh's shuffle moved
            live_model = float(live[i].sum()) * TUPLE_BYTES
            pairs = [recon_pair("live_tuple_bytes", live_model,
                                None if tup is None else float(tup[i])),
                     # the measured exchange is cumulative and amortized
                     # over the word cache (the server-level pair)
                     recon_pair("filter_exchange_bytes", fe_model, None)]
            if not meshless:
                # static collective-buffer model against live tuple bytes:
                # the gap is the dense dataflow's buffer slack
                pairs.append(recon_pair("dist_wire_bytes_model", wire,
                                        float(tup[i])))
            if req._bytes_model is not None:
                # compile-time plan-node model vs this execution's serve-
                # time restatement of the same §3.1 cost
                pairs.append(recon_pair(
                    "node_bytes_model",
                    float(req._bytes_model["bytes_pushdown"]),
                    live_model + fe_model))
            rec = {"query_id": req.query_id, "path": path,
                   "stream": req.stream, "window_id": req.window_id,
                   "plan": req.plan, "plan_node": req.plan_node,
                   "pairs": pairs}
            if dev is not None:
                rec["per_device"] = {"modeled": [wire / k] * k,
                                     "measured": [float(x) for x in dev[i]]}
            out[id(req)] = rec
        return out

    def reconciliation_report(self) -> dict:
        """Modeled-vs-metered byte report: per-query records (traced
        queries), per-path aggregates, and the cumulative server-level
        pairs that exist with tracing off too."""
        d = self.diagnostics
        if self.mesh is None:   # nothing crosses a wire
            return _recon_report(self.tracer.recon, [recon_pair(
                "filter_exchange_bytes", d.filter_exchange_bytes_model,
                None)])
        server_pairs = [
            recon_pair("filter_exchange_bytes", d.filter_exchange_bytes_model,
                       d.filter_exchange_bytes_measured),
            recon_pair("dist_wire_bytes_model", d.dist_wire_bytes_model,
                       d.dist_shuffled_tuple_bytes),
            # the kernel route's gathers to rank 0 are unmodeled cost:
            # modeled 0, so any metered bytes surface as model error
            recon_pair("kernel_gather_bytes", 0.0,
                       d.kernel_gather_bytes or None)]
        return _recon_report(self.tracer.recon, server_pairs)

    def query_trace(self, query_id: str) -> list:
        """Span forest of every traced execution of ``query_id`` (each
        request instance roots its own ``query`` span)."""
        return span_tree(e for e in self.tracer.events
                         if e["args"].get("query_id") == query_id)
