"""Windowed streaming ApproxJoin: unbounded micro-batches, bounded state.

StreamApprox extended the ApproxJoin dataflow to unbounded streams: online
sampling over micro-batches preserves the paper's error bounds without ever
seeing the whole input.  This module is that subsystem for the serving
engine: a :class:`StreamJoinSession` accepts per-tenant micro-batches of
every join input and serves tumbling- or sliding-window ApproxJoin estimates
— each window carrying the paper's CLT error bound — through a
:class:`StreamJoinServer` (a
:class:`~repro_torch.runtime.join_serve.JoinServer` with per-tenant
admission control).  It is the port of the JAX package's streaming
server, on one device or on a mesh (``StreamJoinServer(mesh=...)``).

What is incremental, and what licenses it:

* **Filters.**  A window's per-input Bloom filter is the OR of its
  sub-windows' filters (scatter-OR is a set union).  Each arriving
  micro-batch is fingerprinted and its filter words built ONCE through the
  server's filter-word cache; emission ORs the cached words and expiry
  drops them from the OR — and retires them from the cache.  Sliding a window by one sub-window therefore costs exactly one
  new build per input; every surviving sub-window is a cache hit.  Because
  the OR equals a from-scratch build over the window's concatenated rows,
  the served window is **bit-identical** to re-registering the window as a
  static dataset.
* **Stage callables.**  Every window of a session lands in one serving
  shape class (sub-windows are fixed-capacity slots, windows pad to one pow2
  bucket), so steady-state streaming builds no new stage: the
  ``prepare``/``sample``/``exact`` stages all live in the server's stage
  cache.  The words' OR, the window assembly and the reservoir folds are
  plain calls: PyTorch compiles nothing, so caching them would save
  nothing.
* **Seeds.**  ``JoinRequest.filter_seed`` decouples the filter hash (fixed
  per session, so cached words stay valid across windows) from the sampling
  seed (``seed + 1 + w`` for window ``w``, so per-window draws are
  independent — the accuracy gate depends on this).
* **Estimator parts.**  Disjoint windows sample independently, so their
  :class:`~repro_torch.core.estimators.SumParts` ADD:
  :meth:`StreamJoinSession.running_estimate` folds each emitted
  non-overlapping window's parts into a running whole-stream estimate with
  a CLT bound, at O(1) state.
* **Kernels.**  ``use_kernels=True`` sessions serve their windows through
  the engine's batched kernel route: sub-window filter words build once
  through the CUDA build kernel (bit-identical to the plain build, so the
  word cache is shared), the window's OR-merge feeds the stacked
  ``[B, num_blocks, 8]`` filter probe directly (``JoinRequest._words``), and
  the decoupled filter/sampling seeds are runtime kernel operands.  The OR,
  the window assembly and the reservoir folds are plain PyTorch, as the JAX
  package computes them outside its kernels.
* **Sketch.**  A merge-able per-stratum reservoir
  (:class:`~repro_torch.core.sampling.Reservoir`) folds every micro-batch's
  values in bounded memory — stream-level per-stratum value moments for
  monitoring and sizing, independent of any window.  It lives on the device
  of the session's micro-batches.

Admission lives in :class:`StreamJoinServer`: each session may have at most
``window_slots`` windows queued — beyond that the OLDEST queued window is
shed (marked, never served, counted in ``StreamDiagnostics.windows_shed``)
so a backed-up tenant degrades to fresh windows instead of unbounded queue
growth.  Scheduling is the base server's deadline-aware policy.

The push path copies to the host once per micro-batch and input (its
fingerprint) and once per admitted micro-batch longer than the sub-window
slot (the count of the rows it drops); draining copies each finished
window's estimator parts once.

**On a mesh** (rank 0 serves, ranks 1..k-1 run the server's worker loop):

* **Rows.**  Admitted micro-batches stay whole on rank 0, and each window,
  assembled there in arrival order, is scattered over the ranks when it is
  submitted, as any request's relations are: rank ``d`` holds rows
  ``[d W/k, (d+1) W/k)`` of the window in its global order, the layout
  whose gather merge equals the single-device server bit for bit.
  (Scattering each micro-batch at push, as the JAX package shards it,
  would give a rank its blocks of the sub-windows, whose concatenation is
  a row permutation of its block of the window.)  The scatter moves ``12 x
  window capacity x (k - 1) / k`` bytes a side and window
  (:meth:`StreamJoinSession.window_scatter_bytes_model`).  A kernel
  session's windows are single-device classes and stay on rank 0.
* **Filters.**  A sub-window's words are built once, on the ranks: its
  rows are scattered for the build, every rank builds its block's
  partition filter (through the build kernel for a kernel session) and
  the OR-reduce leaves the sub-window's filter on every rank under a word
  id, cached like a dataset's.  A plain window's filter is the OR of its
  sub-windows' word ids, folded on every rank under a word id of its own
  (the header carries ids only); it is released once the window is served
  or shed.  Retiring a sub-window releases its words on the ranks.
* **Bucket plan.**  Each finished window's overlap fraction updates the
  session's rolling ``overlap_ewma`` (smoothing ``overlap_alpha``), the
  hint a psum window's shuffle buckets are planned from.

:meth:`StreamJoinServer.snapshot_state` adds every session's live state to
the engine's snapshot (sub-windows with their fingerprints, sketches, the
running parts, the buffer bookkeeping), so a failover successor's
restored session emits the same future windows as the uninterrupted one.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.core import bloom
from repro_torch.core.budget import QueryBudget
from repro_torch.core.estimators import (Estimate, SumParts, clt_finish,
                                         clt_sum_parts)
from repro_torch.core.relation import (Relation, bucket_capacity, fingerprint,
                                       pad_to)
from repro_torch.core.sampling import (Reservoir, reservoir_empty,
                                       reservoir_extend, reservoir_moments)
from repro_torch.core.window import (SubWindow, WindowBuffer, WindowSpec,
                                     window_relations)
from repro_torch.runtime.join_serve import (DEFAULT_B_MAX, JoinRequest,
                                            JoinServer)
from repro_torch.runtime.telemetry import MetricsRegistry, latency_pcts


def _or_words(words):
    """OR of sub-window filter words: n_subs x [num_blocks, W] -> one."""
    out = words[0] | words[1]
    for w in words[2:]:
        out |= w
    return out


# StreamDiagnostics scalar counters:
#   admission_dropped_rows — micro-batch rows beyond the sub-window slot cap
#   windows_shed — dropped by per-tenant admission, never served
#   windows_served — served windows (the window-latency ring's population)
#   retired_filter_words — expired sub-window words evicted from the cache
_STREAM_SCALAR_FIELDS = ("sessions", "sub_windows", "admission_dropped_rows",
                         "windows_emitted", "windows_served", "windows_shed",
                         "retired_filter_words")


class StreamDiagnostics:
    """Streaming-side counters (the join counters stay in the base
    ``ServerDiagnostics`` — one serving engine, one set of cache meters).

    Backed by the same :class:`~repro_torch.runtime.telemetry.MetricsRegistry`
    as the owning server's ``ServerDiagnostics`` (metric names carry a
    ``stream_`` prefix), and ``snapshot()`` uses the same percentile
    helper/schema (``window_latency_p50_s``/``_p95_s``/``_max_s``), so one
    scrape covers stream and batch metrics alike.
    """

    _SCALARS = frozenset(_STREAM_SCALAR_FIELDS)

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = MetricsRegistry() if registry is None else registry
        for f in _STREAM_SCALAR_FIELDS:
            self.registry.counter("stream_" + f)
        # bounded ring of per-window ingest->complete latencies
        self._lat = self.registry.histogram("stream_window_latencies")

    def __getattr__(self, name):
        d = object.__getattribute__(self, "__dict__")
        reg = d.get("registry")
        if reg is not None and name in self._SCALARS:
            return reg.counter("stream_" + name).value
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in self._SCALARS:
            self.registry.counter("stream_" + name).value = value
        else:
            object.__setattr__(self, name, value)

    def note_window_latency(self, e2e_s: float, cap: int) -> None:
        """Record one served window's ingest->complete latency."""
        self.windows_served += 1
        self._lat.cap = cap
        self._lat.observe(e2e_s)

    def scalars(self) -> dict:
        """The scalar counters as a plain dict."""
        return {f: getattr(self, f) for f in _STREAM_SCALAR_FIELDS}

    def snapshot(self) -> dict:
        """Read-only, idempotent view (same contract and percentile schema
        as ``ServerDiagnostics.snapshot``)."""
        d = self.scalars()
        d.update(latency_pcts(self._lat.samples, "window_latency"))
        return d


class StreamJoinSession:
    """One tenant's windowed streaming join (construct via
    :meth:`StreamJoinServer.open_stream`).

    ``push`` admits one micro-batch per join input, emits any windows that
    became due as queries on the server's queue, and returns them; call
    ``server.run()`` (or ``step()``) to serve, then :meth:`drain` for the
    finished windows in completion order.  The windows run on the device
    the micro-batches lie on.
    """

    def __init__(self, server: "StreamJoinServer", name: str,
                 spec: WindowSpec, *, n_sides: int = 2,
                 budget: QueryBudget = QueryBudget(),
                 agg: str = "sum", expr: str = "sum", dedup: bool = False,
                 seed: int = 0, fp_rate: float = 0.01,
                 max_strata: Optional[int] = None,
                 b_max: Optional[int] = DEFAULT_B_MAX,
                 serve_mode: Optional[str] = None,
                 use_kernels: bool = False,
                 sketch_strata: int = 64, sketch_cap: int = 64,
                 overlap_alpha: float = 0.5):
        self.server = server
        self.name = name
        self.spec = spec.validate()
        self.n_sides = n_sides
        self.budget = budget
        self.agg, self.expr, self.dedup = agg, expr, dedup
        self.use_kernels = use_kernels
        self.seed = seed
        self.filter_seed = seed
        self.fp_rate = fp_rate
        self.b_max = b_max
        self.serve_mode = serve_mode
        # every window of the session shares one shape class: fixed
        # sub-window slots, window capacity = one pow2 bucket (at least the
        # mesh's size, which must divide it)
        self.sub_cap = bucket_capacity(spec.sub_rows, minimum=server.mesh_k)
        self.window_cap = bucket_capacity(spec.size * self.sub_cap,
                                          minimum=server.mesh_k)
        self.max_strata = self.window_cap if max_strata is None else max_strata
        self.num_blocks = bloom.num_blocks_for(self.window_cap, fp_rate)
        self.buffer = WindowBuffer(spec)
        self.query_id = f"{name}/stream"
        self.pending: list[JoinRequest] = []
        self.results: list[JoinRequest] = []
        # running whole-stream accumulation of disjoint windows' parts
        self._running = (0.0, 0.0, 0.0, 0.0, 0.0)
        self._acc_end = 0
        self.accumulated_windows = 0
        # bounded per-stratum value reservoirs, one per input, made on the
        # first micro-batch's device (None: built with sketch_cap=0)
        self.sketch_strata, self.sketch_cap = sketch_strata, sketch_cap
        self.sketch = [None] * n_sides if sketch_cap else None
        # rolling Bloom-probe overlap of the finished windows (a mesh only;
        # None until the first window lands, so the first psum plan is the
        # lossless overlap-1.0 one)
        self.overlap_alpha = overlap_alpha
        self.overlap_ewma: Optional[float] = None

    # -- ingestion ----------------------------------------------------------

    def _admit_micro_batch(self, r: Relation) -> Relation:
        """Bound one micro-batch to its sub-window slot (rows beyond the cap
        are dropped and counted — bounded-memory admission)."""
        cap = self.sub_cap
        if r.capacity > cap:
            dropped = int(r.valid[cap:].sum().item())
            self.server.stream_diagnostics.admission_dropped_rows += dropped
            r = Relation(r.keys[:cap], r.values[:cap], r.valid[:cap])
        elif r.capacity < cap:
            r = pad_to(r, cap)
        return r

    def _admit(self, tick: int, rels: Sequence[Relation]) -> SubWindow:
        """Admitted micro-batches of one tick and their fingerprints."""
        admitted = tuple(self._admit_micro_batch(r) for r in rels)
        return SubWindow(tick, admitted,
                         tuple(fingerprint(r) for r in admitted))

    def _fold_sketch(self, sub: SubWindow) -> None:
        for side, r in enumerate(sub.rels):
            res = self.sketch[side]
            if res is None:
                res = reservoir_empty(self.sketch_strata, self.sketch_cap,
                                      device=r.keys.device)
            self.sketch[side] = reservoir_extend(
                res, r.keys, r.values, r.valid, self.filter_seed, sub.index)

    def push(self, rels: Sequence[Relation]) -> list[JoinRequest]:
        """Admit one micro-batch per side; returns the windows that became
        due (already submitted to the server, not yet served)."""
        if len(rels) != self.n_sides:
            raise ValueError(f"expected {self.n_sides} inputs, got "
                             f"{len(rels)}")
        sub = self._admit(self.buffer.arrived, rels)
        if self.sketch is not None:
            self._fold_sketch(sub)
        due, expired = self.buffer.push(sub)
        self.server.stream_diagnostics.sub_windows += 1
        out = [self._emit(w, subs) for w, subs in due]
        # retire AFTER emission: a sub-window can expire in the same push
        # that emits its last window, and that window still needs its words
        self._retire(expired)
        return out

    def _retire(self, expired: Sequence[SubWindow]) -> None:
        """Evict expired sub-window filter words.

        The filter-word cache is server-global, so the keep-set must span
        EVERY session's live sub-windows: two sessions consuming the same
        upstream micro-batches under the same seed share cache entries, and
        one session expiring must not evict words the other still needs
        (that would silently re-pay the full-window rebuild the subsystem
        exists to avoid).
        """
        keep = {fp for sess in self.server.sessions.values()
                for s in sess.buffer.live for fp in s.fps}
        for sub in expired:
            for fp in sub.fps:
                if fp in keep:
                    continue
                # on a mesh the ranks drop the words too
                if self.server._evict_words(
                        (fp, self.num_blocks, self.filter_seed)):
                    self.server.stream_diagnostics.retired_filter_words += 1

    # -- emission -----------------------------------------------------------

    def _window_words(self, subs: Sequence[SubWindow]) -> tuple:
        """Per-side window filter words: OR of the cached sub-window builds
        (new sub-windows build, survivors hit the cache).  On a mesh also
        the word ids under which a plain session's ranks hold each side's
        OR (None for a kernel session, which serves on rank 0 alone)."""
        srv = self.server
        words, keys = [], []
        for side in range(self.n_sides):
            if srv.mesh is None:
                sub_words = [srv._words_for(s.rels[side], s.fps[side],
                                            self.num_blocks, self.filter_seed,
                                            use_kernels=self.use_kernels)
                             for s in subs]
            else:
                got = [srv._mesh_words_for(s.rels[side], s.fps[side],
                                           self.num_blocks, self.filter_seed,
                                           self.use_kernels, [])
                       for s in subs]
                sub_words = [w for _, w in got]
                if not self.use_kernels:
                    keys.append(srv._or_words_on_ranks([k for k, _ in got]))
            words.append(sub_words[0] if len(sub_words) == 1
                         else _or_words(sub_words))
        return words, (keys or None)

    def window_scatter_bytes_model(self) -> float:
        """Bytes rank 0's scatter of one window puts on the wire (every
        side; a row travels as three int32s to each of the other ranks'
        blocks); 0 off a mesh and for a kernel session."""
        srv = self.server
        if srv.mesh is None or self.use_kernels:
            return 0.0
        world = torch.distributed.get_world_size()
        return float(self.n_sides * 12 * self.window_cap * (world - 1)
                     // srv.mesh_k)

    def _emit(self, w: int, subs: Sequence[SubWindow]) -> JoinRequest:
        self._drain_finished()
        req = JoinRequest(
            rels=window_relations(subs, minimum=self.server.mesh_k),
            budget=self.budget, agg=self.agg, expr=self.expr,
            query_id=self.query_id, seed=self.seed + 1 + w,
            filter_seed=self.filter_seed, fp_rate=self.fp_rate,
            max_strata=self.max_strata, b_max=self.b_max, dedup=self.dedup,
            use_kernels=self.use_kernels, serve_mode=self.serve_mode,
            overlap_hint=self.overlap_ewma, stream=self.name, window_id=w)
        req._words, req._word_keys = self._window_words(subs)
        self.server._submit_window(self, req)
        self.pending.append(req)
        self.server.stream_diagnostics.windows_emitted += 1
        return req

    # -- results ------------------------------------------------------------

    def _drain_finished(self) -> None:
        still = []
        for req in self.pending:
            if req.shed:
                continue                       # counted at shed time
            if not req.done:
                still.append(req)
                continue
            self.results.append(req)
            if self.server.mesh is not None:
                # the rolling overlap only feeds the mesh psum bucket plan;
                # off the mesh there is no reader, so skip the host copy
                obs = float(req.result.diagnostics.overlap_fraction)
                if math.isfinite(obs):
                    self.overlap_ewma = obs if self.overlap_ewma is None \
                        else (self.overlap_alpha * obs
                              + (1.0 - self.overlap_alpha)
                              * self.overlap_ewma)
            self._accumulate(req)
        self.pending = still

    def drain(self) -> list[JoinRequest]:
        """Finished (served) window requests since the last drain."""
        self._drain_finished()
        out, self.results = self.results, []
        return out

    def _accumulate(self, req: JoinRequest) -> None:
        """Fold a non-overlapping window's estimator parts into the running
        whole-stream estimate (disjoint windows sample independently, so
        their SumParts ADD).  SUM only; shed windows leave a counted gap."""
        if self.agg != "sum" or self.dedup:
            return
        start, end = self.spec.start(req.window_id), self.spec.end(
            req.window_id)
        if start < self._acc_end:
            return                              # overlaps accumulated span
        res = req.result
        f64 = torch.float64
        if res.stats is not None:
            p = clt_sum_parts(res.stats)
            parts = tuple(torch.stack([x.to(f64) for x in p]).tolist())
        else:                                   # exact window: zero variance
            est, cnt = torch.stack([res.estimate.to(f64),
                                    res.count.to(f64)]).tolist()
            parts = (est, 0.0, 0.0, 0.0, cnt)
        self._running = tuple(a + b for a, b in zip(self._running, parts))
        self._acc_end = end
        self.accumulated_windows += 1

    def running_estimate(self,
                         confidence: Optional[float] = None
                         ) -> Optional[Estimate]:
        """CLT estimate of the stream-total SUM over every accumulated
        (disjoint) window, O(1) state, as float64 0-d CPU tensors.  None
        before the first window."""
        if not self.accumulated_windows:
            return None
        parts = SumParts(*(torch.tensor(x, dtype=torch.float64)
                           for x in self._running))
        return clt_finish(parts, self.budget.confidence if confidence is None
                          else confidence)

    def sketch_moments(self, side: int):
        """(n, mean, var) per sketch stratum of input ``side`` — the
        bounded-memory stream-level value moments from the reservoir."""
        assert self.sketch is not None, "session built with sketch_cap=0"
        assert self.sketch[side] is not None, "no micro-batch pushed yet"
        return reservoir_moments(self.sketch[side])


class StreamJoinServer(JoinServer):
    """A JoinServer that owns streaming sessions and their admission.

    ``window_slots`` bounds each session's queued-but-unserved windows;
    emitting past the bound sheds the session's OLDEST queued window
    (freshness over completeness — the shed window is marked and counted,
    never silently lost).  Everything else — stage keys, filter-word
    cache, sigma registry, deadline-aware scheduling, sigma pipelining — is
    the base engine, shared with static queries on the same server.
    """

    def __init__(self, *, window_slots: int = 8, **kw):
        super().__init__(**kw)
        self.window_slots = window_slots
        self.sessions: dict[str, StreamJoinSession] = {}
        # one registry across server + stream diagnostics: a single
        # snapshot/Prometheus scrape covers the whole serving surface
        self.stream_diagnostics = StreamDiagnostics(
            registry=self.diagnostics.registry)

    def open_stream(self, name: str, spec: WindowSpec,
                    **kw) -> StreamJoinSession:
        if name in self.sessions:
            raise ValueError(f"stream {name!r} already open")
        session = StreamJoinSession(self, name, spec, **kw)
        self.sessions[name] = session
        self.stream_diagnostics.sessions += 1
        return session

    def _submit_window(self, session: StreamJoinSession,
                       req: JoinRequest) -> None:
        queued = [r for r in self.queue if r.stream == session.name]
        while len(queued) >= self.window_slots:
            victim = queued.pop(0)
            # drop by identity: the victim is rarely at the queue head in a
            # multi-tenant queue, and requests are identities, not values
            self.queue = [r for r in self.queue if r is not victim]
            victim.shed = True
            self._release_request_words(victim)
            self.stream_diagnostics.windows_shed += 1
            self.tracer.instant(
                "shed", cat="admission", tid=self.trace_name,
                query_id=victim.query_id, stream=victim.stream,
                window=victim.window_id, qspan=victim._span_id)
            # a shed window is terminal: fire the completion hook so a
            # caller waiting on it learns it will never be served
            self._notify_done(victim)
        self.submit(req)

    def _notify_done(self, req: JoinRequest) -> None:
        if req.stream is not None and req.done and not req.shed:
            self.stream_diagnostics.note_window_latency(
                req.e2e_latency_s, self.latency_samples)
        super()._notify_done(req)

    # -- crash safety: snapshot / restore -----------------------------------

    def snapshot_state(self) -> tuple[dict, dict]:
        """Engine snapshot + every streaming session's live state.

        Per session: window-buffer bookkeeping (``arrived``/``emitted``) and
        live sub-windows (relations + fingerprints), per-side reservoir
        sketches, the cross-window running ``SumParts`` accumulation, the
        carried overlap estimate, and the full session configuration:
        enough for :meth:`restore_state` to rebuild a session whose FUTURE
        windows (ids, seeds, emission points) are bit-identical to the
        uninterrupted session's.  Finished-but-undrained windows are folded
        into the accumulation first (exactly what the next ``push`` would
        do); their request objects are not checkpointed: completion futures
        already resolved when they were served."""
        for sess in self.sessions.values():
            sess._drain_finished()
        flat, meta = super().snapshot_state()
        sess_meta = []
        for si, (name, s) in enumerate(self.sessions.items()):
            for j, sub in enumerate(s.buffer.live):
                for side in range(s.n_sides):
                    self._rel_arrays(flat, f"sess/{si}/live/{j}/{side}",
                                     sub.rels[side])
            # a sketch exists from the session's first push on
            if s.sketch is not None and s.sketch[0] is not None:
                for side, res in enumerate(s.sketch):
                    flat[f"sess/{si}/sketch/{side}/priority"] = res.priority
                    flat[f"sess/{si}/sketch/{side}/values"] = res.values
                    flat[f"sess/{si}/sketch/{side}/n_seen"] = res.n_seen
            sess_meta.append({
                "name": name, "spec": list(s.spec), "n_sides": s.n_sides,
                "budget": list(s.budget), "agg": s.agg, "expr": s.expr,
                "dedup": s.dedup, "seed": s.seed,
                "filter_seed": s.filter_seed, "fp_rate": s.fp_rate,
                "max_strata": s.max_strata, "b_max": s.b_max,
                "serve_mode": s.serve_mode, "use_kernels": s.use_kernels,
                "sketch_strata": s.sketch_strata,
                "sketch_cap": s.sketch_cap,
                "overlap_alpha": s.overlap_alpha,
                "overlap_ewma": s.overlap_ewma,
                "running": list(s._running), "acc_end": s._acc_end,
                "accumulated_windows": s.accumulated_windows,
                "arrived": s.buffer.arrived, "emitted": s.buffer.emitted,
                "live": [{"index": sub.index, "fps": list(sub.fps)}
                         for sub in s.buffer.live]})
        meta["sessions"] = sess_meta
        meta["stream_diag"] = self.stream_diagnostics.scalars()
        return flat, meta

    def restore_state(self, flat: dict, meta: dict,
                      device=None) -> list[JoinRequest]:
        """Engine restore + session adoption, every tensor on ``device``
        (the card unless the caller asks for the CPU).

        Sessions are rebuilt through :meth:`open_stream` with their saved
        configuration, then their buffers/sketches/accumulators are
        overwritten from the snapshot (sub-window fingerprints come from the
        snapshot, matching the restored filter-word cache keys, so surviving
        sub-windows keep hitting the cache).  Queued window requests
        restored by the base engine re-attach to their sessions' pending
        lists in saved (window-id) order; they were admitted pre-crash, so
        they bypass admission shedding: a failover sheds zero windows."""
        restored = super().restore_state(flat, meta, device)
        device = torch.device("cuda" if device is None else device)
        for si, m in enumerate(meta.get("sessions", [])):
            s = self.open_stream(
                m["name"], WindowSpec(*m["spec"]), n_sides=m["n_sides"],
                budget=QueryBudget(*m["budget"]), agg=m["agg"],
                expr=m["expr"], dedup=m["dedup"], seed=m["seed"],
                fp_rate=m["fp_rate"], max_strata=m["max_strata"],
                b_max=m["b_max"], serve_mode=m.get("serve_mode"),
                use_kernels=m["use_kernels"],
                sketch_strata=m["sketch_strata"],
                sketch_cap=m["sketch_cap"],
                overlap_alpha=m.get("overlap_alpha", 0.5))
            s.filter_seed = m["filter_seed"]
            s.overlap_ewma = m["overlap_ewma"]
            s._running = tuple(m["running"])
            s._acc_end = m["acc_end"]
            s.accumulated_windows = m["accumulated_windows"]
            s.buffer.arrived = m["arrived"]
            s.buffer.emitted = m["emitted"]
            for j, sub_m in enumerate(m["live"]):
                # a sub-window's rows stay whole on rank 0
                rels = tuple(
                    self._rel_restore(flat, f"sess/{si}/live/{j}/{side}",
                                      device, scatter=False)
                    for side in range(s.n_sides))
                s.buffer.live.append(
                    SubWindow(sub_m["index"], rels, tuple(sub_m["fps"])))
            if s.sketch is not None \
                    and f"sess/{si}/sketch/0/priority" in flat:
                s.sketch = [Reservoir(*(
                    torch.as_tensor(flat[f"sess/{si}/sketch/{d}/{f}"],
                                    device=device)
                    for f in Reservoir._fields)) for d in range(s.n_sides)]
        for req in restored:
            if req.stream is not None and req.stream in self.sessions:
                self.sessions[req.stream].pending.append(req)
        for f, v in meta.get("stream_diag", {}).items():
            if f == "sessions":
                continue            # open_stream above already counted them
            setattr(self.stream_diagnostics, f,
                    getattr(self.stream_diagnostics, f) + v)
        return restored
