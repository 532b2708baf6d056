"""Always-on asynchronous serving tier: per-replica event loops with
continuous batching, and a tenant-sharded multi-replica front door.

The engine (``runtime/join_serve.py``) is caller-driven: nothing happens
between ``step()`` calls, so a query's queue latency is however long the
driver sleeps, not however long the engine needs.  This module, the port of
the JAX package's ``runtime/async_serve.py``, closes that
gap the way LLM serving engines do (on one device or on a mesh: the
replicas may be mesh servers over the same ranks, each its own server id,
whose operations the mesh lock of ``runtime/join_serve.py`` serialises):

* :class:`AsyncJoinServer` runs ONE engine on a dedicated event-loop
  thread.  ``submit()`` is ingestion only — it appends to a lock-protected
  ingress ring and returns a ``concurrent.futures.Future`` immediately;
  admission (bucketing, sharding, validation) and every device dispatch
  happen on the loop thread.  The loop serves **continuous batches**: it
  never waits for a full same-class batch.  Whatever is queued when the
  previous step retires is dispatched after at most ``linger_s`` of slot
  backfill, and requests arriving while a step is in flight land in the
  ingress ring and backfill the NEXT batch's open slots instead of waiting
  for a caller to come back.  The linger is cut short the moment some
  shape class can fill every slot, or a queued latency budget's deadline
  comes within ``deadline_margin_s``; scheduling *within* a step stays the
  engine's deadline-aware ``_take_batch``.
* :class:`AsyncJoinFrontDoor` runs N replica event loops and shards
  TENANTS (the ``query_id`` prefix, :func:`~.join_serve.tenant_of`) across
  them — sticky, so one tenant's sigma feedback stays sequential on one
  replica.  All replicas share one ``SigmaRegistry``.  An idle replica
  STEALS the entire pending run of one tenant from the most backed-up
  replica: whole-tenant moves preserve same-``query_id`` order (nothing of
  that tenant is in flight while the victim's engine lock is held), so
  stolen work is bit-identical to unstolen work.  Streaming tenants are
  pinned — their admission bookkeeping and session state live on the
  owning replica.

Correctness contract: per-query results through the async tier are
bit-identical to the synchronous server (and therefore to a direct
``approx_join``).  Slot results never depend on batch composition, and
per-``query_id`` execution order — the only thing sigma feedback
observes — is preserved end to end: ingress is FIFO, the engine's
scheduler keeps same-id FIFO (sigma pipelining defers repeats without
reordering), and stealing moves a tenant wholesale under the front-door
lock.  Asserted in ``tests/test_torch_async_serve.py``.

Devices: a replica's batches run where its relations lie, and every
replica's loop thread launches on the device's current stream: all
replicas of one card share that one stream, so no result crosses streams.
A failover successor restores a dead replica's checkpoint onto the front
door's ``device`` (the card unless the caller asks for the CPU), and onto
its mesh when it is a mesh server; the dead replica's mesh state is then
dropped on the ranks.

Steals and checkpoints (a departure from the JAX package, whose fleet can
serve a query twice): a steal marks the victim (and the thief) dirty, so
the next checkpoint no longer holds the stolen requests, and a failover
successor drops the restored requests of every tenant the front door
assigns to another replica: the dead replica gave those up after its last
checkpoint, and their thief serves them.

Locking (strict order ``front-door _alock`` > ``replica _elock`` >
``replica _cv``; no thread ever acquires leftward while holding
rightward): ``_cv`` guards the ingress ring and is held only for ring
append/swap; ``_elock`` guards every engine mutation — the loop holds it
across ``step()``, a thief acquires the victim's with a short bounded wait
(flagging ``_steal_wanted`` so a saturated victim loop yields between
steps; a victim mid-step past the wait is simply skipped this round);
``_alock`` serialises tenant routing
against steals so a submission racing a steal cannot land behind its
predecessors.
"""

from __future__ import annotations

import os
import threading
import time
from collections import Counter
from concurrent.futures import Future
from functools import partial
from typing import Callable, Optional, Sequence

from repro_torch.core.cost import SigmaRegistry
from repro_torch.core.relation import Relation
from repro_torch.runtime.checkpoint import latest_step, save_checkpoint
from repro_torch.runtime.fault import (Heartbeat, InjectedFault,
                                       elastic_restore_engine, guarded_step)
from repro_torch.runtime import join_serve
from repro_torch.runtime.join_serve import JoinRequest, JoinServer, tenant_of
from repro_torch.runtime.stream_join import (StreamJoinServer,
                                             StreamJoinSession)
from repro_torch.runtime.telemetry import NULL_TRACER, Tracer

DEFAULT_LINGER_S = 0.002


class AsyncJoinServer:
    """One engine + one event-loop thread: ingestion-decoupled, always on.

    ``engine`` is any :class:`~.join_serve.JoinServer` (a
    :class:`~.stream_join.StreamJoinServer` enables :meth:`open_stream` /
    :meth:`push`); with ``engine=None`` one is constructed from
    ``engine_kw``.  The server owns the engine exclusively once
    constructed: callers interact through :meth:`submit` (returns a
    future), :meth:`call` (run a closure on the loop thread — the door to
    every other engine method), and :meth:`close`.
    """

    def __init__(self, engine: Optional[JoinServer] = None, *,
                 linger_s: float = DEFAULT_LINGER_S,
                 deadline_margin_s: float = 0.010,
                 idle_wait_s: float = 0.010,
                 name: str = "replica0",
                 front_door: Optional["AsyncJoinFrontDoor"] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every_s: float = 0.0,
                 heartbeat: Optional[Heartbeat] = None,
                 step_retries: int = 0, step_backoff_s: float = 0.0,
                 **engine_kw):
        self.engine = JoinServer(**engine_kw) if engine is None else engine
        assert self.engine.on_done is None, \
            "engine already owned by an async tier"
        self.engine.on_done = self._on_done
        # replica-tag the engine's trace lane: every event the engine emits
        # from here on carries this replica's name, so a shared front-door
        # tracer separates replicas into distinct perfetto threads
        self.engine.trace_name = name
        self.linger_s = linger_s
        self.deadline_margin_s = deadline_margin_s
        self.idle_wait_s = idle_wait_s
        self.name = name
        self.error: Optional[BaseException] = None
        # checkpoint_s: seconds the loop held the engine lock to capture
        # checkpoints (snapshot and host copy; the write runs after)
        self.stats = {"ingested": 0, "calls": 0, "backfilled": 0,
                      "stolen_in": 0, "stolen_out": 0, "checkpoints": 0,
                      "checkpoint_s": 0.0}
        self._front = front_door
        # crash safety: when checkpoint_dir is set the loop snapshots the
        # engine (under _elock, between steps) whenever state changed and
        # the cadence allows (every opportunity at the 0.0 default) and
        # hands the host arrays to checkpoint.py's async writer, so a
        # successor can restore the newest complete checkpoint
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every_s = checkpoint_every_s
        self.heartbeat = heartbeat
        # transient-failure policy for engine steps (guarded_step): 0
        # retries by default — a serving step is not a training step whose
        # inputs regenerate deterministically, so retry only on request
        self.step_retries = step_retries
        self.step_backoff_s = step_backoff_s
        self._ckpt_writer: Optional[threading.Thread] = None
        last = latest_step(checkpoint_dir) if checkpoint_dir else None
        self._ckpt_step = 0 if last is None else last + 1
        self._last_ckpt_t = 0.0
        self._dirty = False
        self._kill_after: Optional[int] = None
        # ingress ring: ("req", JoinRequest, Future) | ("call", fn, Future)
        self._ingress: list[tuple] = []
        self._cv = threading.Condition()
        self._elock = threading.RLock()
        self._running = True
        self._in_linger = False
        self._steal_wanted = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"async-join-{name}")
        self._thread.start()

    # -- ingestion (any thread) ---------------------------------------------

    def submit(self, req: JoinRequest) -> Future:
        """Enqueue one query; returns a future resolving to the served
        request (``req.result`` populated; ``req.shed`` set if admission
        dropped it).  O(1): admission and execution happen on the loop."""
        fut: Future = Future()
        now = time.perf_counter()
        with self._cv:
            self._check_open()
            if not req._ingest_t:
                req._ingest_t = now
            self._ingress.append(("req", req, fut))
            self._cv.notify_all()
        return fut

    def call(self, fn: Callable) -> Future:
        """Run ``fn()`` on the event-loop thread (between steps), resolving
        to its return value — the safe door to every engine method that
        ``submit`` doesn't cover (``register_dataset``, ``open_stream``,
        diagnostics mutation, ...)."""
        fut: Future = Future()
        with self._cv:
            self._check_open()
            self._ingress.append(("call", fn, fut))
            self._cv.notify_all()
        return fut

    def register_dataset(self, name: str, rels: Sequence[Relation]) -> None:
        self.call(partial(self.engine.register_dataset, name, rels)).result()

    def open_stream(self, name: str, spec, **kw) -> StreamJoinSession:
        """Open a streaming session on the loop thread (engine must be a
        ``StreamJoinServer``).  Interact with the session via :meth:`push`;
        results arrive through the returned window futures."""
        assert isinstance(self.engine, StreamJoinServer), \
            "open_stream needs a StreamJoinServer engine"
        return self.call(
            partial(self.engine.open_stream, name, spec, **kw)).result()

    def push(self, session: StreamJoinSession,
             rels: Sequence[Relation]) -> list[Future]:
        """Admit one micro-batch per side; returns one future per window
        that became due.  A future resolves when its window is served — or
        immediately with ``.shed`` set if per-tenant admission later drops
        it (the engine's shed hook fires this tier's resolver)."""
        def _push():
            out = session.push(rels)
            futs = []
            for req in out:
                f: Future = Future()
                req._future = f
                futs.append(f)
            return futs
        return self.call(_push).result()

    def push_by_name(self, name: str, rels: Sequence[Relation]) -> \
            list[Future]:
        """:meth:`push` by session name — the session object is resolved on
        the loop thread.  The failover door: after a replica death the
        caller's session object belongs to the dead engine, but the
        successor's restored session answers to the same name."""
        def _push():
            session = self.engine.sessions[name]
            out = session.push(rels)
            futs = []
            for req in out:
                f: Future = Future()
                req._future = f
                futs.append(f)
            return futs
        return self.call(_push).result()

    def submit_plan(self, plan, *, query_id: str = "plan0",
                    **kw) -> dict:
        """Submit a query plan on the loop thread; returns one future per
        plan node (node name -> future resolving to the served request).
        Node requests share the ``query_id`` tenant prefix, so a front door
        keeps (or steals, or fails over) a plan whole."""
        def _submit():
            handle = self.engine.submit_plan(plan, query_id=query_id, **kw)
            futs = {}
            for name, req in handle.requests.items():
                f: Future = Future()
                req._future = f
                futs[name] = f
            return futs
        return self.call(_submit).result()

    @property
    def tracer(self) -> Tracer:
        """The engine's tracer (``NULL_TRACER`` unless one was attached)."""
        return self.engine.tracer

    def backlog(self) -> int:
        """Pending request count (ingress ring + engine queue)."""
        return len(self._ingress) + len(self.engine.queue)

    def snapshot(self) -> dict:
        with self._elock:
            d = self.engine.diagnostics.snapshot()
        d.update(self.stats)
        d["backlog"] = self.backlog()
        return d

    def close(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop the loop; with ``drain`` (default) serve everything pending
        first.  Unserved requests' futures fail with ``RuntimeError``."""
        if drain:
            deadline = time.monotonic() + timeout
            while (self.backlog() and self.error is None
                   and self._thread.is_alive()
                   and time.monotonic() < deadline):
                time.sleep(0.001)
        with self._cv:
            self._running = False
            self._cv.notify_all()
        self._thread.join(timeout)
        if self._ckpt_writer is not None:
            self._ckpt_writer.join(timeout)
        self._fail_pending(RuntimeError(f"AsyncJoinServer {self.name} "
                                        "closed"))
        # a mesh engine's state on the ranks goes with its replica
        if not self._thread.is_alive():
            self.engine.shutdown()

    def __enter__(self) -> "AsyncJoinServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))

    # -- event loop (loop thread only) --------------------------------------

    def _loop(self) -> None:
        try:
            while self._running:
                if self.heartbeat is not None:
                    self.heartbeat.beat(self.name)
                if self._kill_after is not None and self._kill_after <= 0:
                    # fault drill: die exactly like a crashed process would —
                    # InjectedFault is a BaseException, so nothing below
                    # absorbs it; the handler marks the replica dead and
                    # fails every pending future, and the front door's
                    # failover hands the newest checkpoint to a successor
                    self.tracer.instant("fault", cat="fleet", tid=self.name,
                                        replica=self.name)
                    raise InjectedFault(f"replica {self.name} killed by "
                                        "fault injection")
                if self._steal_wanted.is_set():
                    # a thief is parked on _elock: a saturated loop holds it
                    # back-to-back (drain -> linger -> step), so yield for a
                    # moment or the steal can never win the reacquire race
                    time.sleep(0.001)
                self._drain()
                self._maybe_checkpoint()
                if not self.engine.queue:
                    if self._front is not None:
                        self._front.maybe_failover(blocking=False)
                        if self._front._steal_for(self):
                            continue
                    with self._cv:
                        if self._running and not self._ingress:
                            self._cv.wait(self.idle_wait_s)
                    continue
                if self.tracer.enabled:
                    with self.tracer.span("linger", cat="batch",
                                          tid=self.name,
                                          backlog=self.backlog()):
                        self._linger()
                else:
                    self._linger()
                if not self._running:
                    break
                with self._elock:
                    # guarded_step: transient device failures retry with
                    # exponential backoff when step_retries > 0; an
                    # InjectedFault passes straight through (BaseException)
                    n = guarded_step(lambda _s, _b: self.engine.step(),
                                     None, None, retries=self.step_retries,
                                     backoff_s=self.step_backoff_s)
                if n:
                    self._dirty = True
                    if self._kill_after is not None:
                        self._kill_after -= 1
                self._maybe_checkpoint()
        except BaseException as e:  # noqa: BLE001 — fail futures, don't hang
            self.error = e
            self._fail_pending(e)

    def _maybe_checkpoint(self) -> None:
        """Checkpoint the engine if state changed and the cadence allows.

        Capture (snapshot + host copy) is synchronous under the engine
        lock, so the checkpoint is exactly the state at a step boundary and
        no copy is still in flight when the lock drops; serialization then
        rides checkpoint.py's async writer thread.  The
        previous writer is joined first, so at most one write is in flight
        and a reader joining ``_ckpt_writer`` sees every rename."""
        if self.checkpoint_dir is None or not self._dirty:
            return
        now = time.monotonic()
        if self._last_ckpt_t and \
                now - self._last_ckpt_t < self.checkpoint_every_s:
            return
        if self._ckpt_writer is not None:
            self._ckpt_writer.join()
            if self._ckpt_writer.exception is not None:
                # a writer failure must take the replica down loudly (the
                # loop's error path), never quietly stop checkpointing while
                # serving continues — that would hand a failover successor
                # an arbitrarily stale snapshot
                raise self._ckpt_writer.exception
        with self._elock, \
                self.tracer.span("checkpoint", cat="fleet", tid=self.name,
                                 step=self._ckpt_step):
            t0 = time.perf_counter()
            # cleared under the lock: a steal (which needs it) after this
            # capture marks the replica dirty again
            self._dirty = False
            flat, meta = self.engine.snapshot_state()
            meta["replica"] = self.name
            self._ckpt_writer = save_checkpoint(
                self.checkpoint_dir, self._ckpt_step, flat, sync=False,
                extra=meta)
            self.stats["checkpoint_s"] += time.perf_counter() - t0
        self._ckpt_step += 1
        self._last_ckpt_t = now
        self.stats["checkpoints"] += 1

    def kill_after(self, steps: int) -> None:
        """Fault injection: the loop raises :class:`InjectedFault` after
        serving ``steps`` more engine steps (0 = at the next iteration).
        The last checkpoint before death holds every admitted-but-unserved
        request — the state a failover successor adopts."""
        self._kill_after = steps

    def _drain(self) -> int:
        """Move the ingress ring into the engine (admission on the loop
        thread).  Per-item failures (validation errors) fail that item's
        future only."""
        with self._cv:
            items, self._ingress = self._ingress, []
        if not items:
            return 0
        # any drained item can mutate engine state ("call" items included:
        # a streaming push emits windows) — mark for the next checkpoint
        self._dirty = True
        admitted = 0
        with self._elock:
            for kind, payload, fut in items:
                try:
                    if kind == "req":
                        payload._future = fut
                        self.engine.submit(payload)
                        self.stats["ingested"] += 1
                        admitted += 1
                    else:
                        fut.set_result(payload())
                        self.stats["calls"] += 1
                except Exception as e:  # noqa: BLE001
                    fut.set_exception(e)
        return admitted

    def _linger(self) -> None:
        """Continuous batching: give open slots up to ``linger_s`` to
        backfill from the ingress ring, cut short by a fillable batch or an
        imminent deadline.  This is the ONLY place the loop trades latency
        for batch width, and the trade is bounded."""
        if self.linger_s <= 0:
            return
        t_end = time.perf_counter() + self.linger_s
        while self._running:
            with self._elock:
                if self._batch_ready():
                    return
                guard = self._earliest_deadline() - self.deadline_margin_s
            now = time.perf_counter()
            if now >= t_end or now >= guard:
                return
            with self._cv:
                if not self._ingress:
                    self._cv.wait(max(min(t_end, guard) - now, 0.0))
            self.stats["backfilled"] += self._drain()

    def _batch_ready(self) -> bool:
        """True when some shape class can fill every slot of its next
        batch: lingering past that point buys nothing."""
        counts = Counter(r._class for r in self.engine.queue)
        device = {}
        for r in self.engine.queue:
            device.setdefault(r._class,
                              join_serve._rows_of(r.rels[0]).device)
        return any(n >= self.engine._slot_cap(cls, device[cls])
                   for cls, n in counts.items())

    def _earliest_deadline(self) -> float:
        return min((self.engine._deadline(r) for r in self.engine.queue),
                   default=float("inf"))

    # -- completion / shutdown ----------------------------------------------

    def _on_done(self, req: JoinRequest) -> None:
        """Engine completion hook: resolve the request's future (served or
        shed).  Runs on the loop thread, result fully populated."""
        fut = req._future
        if fut is not None:
            req._future = None
            if not fut.done():
                fut.set_result(req)

    def _check_open(self) -> None:
        if self.error is not None:
            raise RuntimeError(
                f"AsyncJoinServer {self.name} failed") from self.error
        if not self._running:
            raise RuntimeError(f"AsyncJoinServer {self.name} is closed")

    def _fail_pending(self, exc: BaseException) -> None:
        with self._cv:
            self._running = False
            items, self._ingress = self._ingress, []
            self._cv.notify_all()
        futs = [fut for _, _, fut in items]
        with self._elock:
            futs += [r._future for r in self.engine.queue
                     if r._future is not None]
        for fut in futs:
            if not fut.done():
                fut.set_exception(exc)

    # -- work stealing (called by the front door, victim side) ---------------

    def _release_one_tenant(self) -> Optional[tuple]:
        """Cut ONE tenant's entire pending run out of this replica for a
        steal: ``(tenant, admitted requests, raw ingress items)`` or None.
        Bounded-blocking on the engine lock: ``_steal_wanted`` makes the
        victim's loop yield between steps, and the thief waits briefly — a
        victim mid-step for longer than the wait is skipped this round
        rather than stalled on.  The oldest queued non-streaming tenant is
        picked (FIFO fairness; streaming tenants are pinned)."""
        self._steal_wanted.set()
        try:
            if not self._elock.acquire(timeout=0.05):
                return None
        finally:
            self._steal_wanted.clear()
        try:
            with self._cv:
                pinned = {tenant_of(r.query_id) for r in self.engine.queue
                          if r.stream is not None}
                pinned |= {tenant_of(it[1].query_id) for it in self._ingress
                           if it[0] == "req" and it[1].stream is not None}
                tenant = next(
                    (tenant_of(r.query_id) for r in self.engine.queue
                     if tenant_of(r.query_id) not in pinned), None)
                if tenant is None:
                    tenant = next(
                        (tenant_of(it[1].query_id) for it in self._ingress
                         if it[0] == "req"
                         and tenant_of(it[1].query_id) not in pinned), None)
                if tenant is None:
                    return None
                admitted = [r for r in self.engine.queue
                            if tenant_of(r.query_id) == tenant]
                self.engine.queue = [r for r in self.engine.queue
                                     if tenant_of(r.query_id) != tenant]
                moved = [it for it in self._ingress if it[0] == "req"
                         and tenant_of(it[1].query_id) == tenant]
                if moved:
                    self._ingress = [it for it in self._ingress
                                     if it not in moved]
                # the last checkpoint still holds the tenant's requests
                self._dirty = True
                self.stats["stolen_out"] += len(admitted) + len(moved)
                return tenant, admitted, moved
        finally:
            self._elock.release()

    def _accept_stolen(self, admitted: list[JoinRequest],
                       ingress_items: list[tuple]) -> None:
        """Thief side: adopt a stolen tenant's pending run.  Admitted
        requests keep their shape class — replicas must be homogeneous
        (the front door builds them from one configuration)."""
        if admitted:
            with self._elock:
                self.engine.queue.extend(admitted)
                self._dirty = True
        with self._cv:
            if ingress_items:
                self._ingress.extend(ingress_items)
            self._cv.notify_all()
        self.stats["stolen_in"] += len(admitted) + len(ingress_items)


class AsyncJoinFrontDoor:
    """N replica event loops behind one ``submit``: sticky tenant sharding,
    shared sigma registry, work stealing.

    Tenants (the ``query_id`` prefix) are assigned least-loaded-first on
    first sight and stay put, so a tenant's sigma feedback chain runs
    sequentially on one replica; an idle replica steals the whole pending
    run of one tenant from the most backed-up replica (``steals`` counts
    moves).  All replicas share ``self.sigma`` — safe because tenant
    single-ownership means no two replicas ever update the same
    ``query_id`` concurrently.  Replicas are homogeneous by construction:
    one ``engine_factory`` (or one ``engine_kw`` set) builds them all, so
    stolen requests' shape classes stay valid.
    """

    def __init__(self, *, replicas: int = 2,
                 engine_factory: Optional[Callable[[int], JoinServer]] = None,
                 sigma_registry: Optional[SigmaRegistry] = None,
                 work_stealing: bool = True, steal_min_backlog: int = 2,
                 linger_s: float = DEFAULT_LINGER_S,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every_s: float = 0.0,
                 heartbeat_timeout_s: float = 5.0,
                 tracer: Optional[Tracer] = None, device=None,
                 **engine_kw):
        assert replicas >= 1, replicas
        # where a failover successor restores a dead replica's checkpoint
        # (None: the card)
        self.device = device
        # one SHARED tracer across the fleet: replica engines tag their
        # events with their replica name (pid lanes in the chrome export),
        # and fleet-level events (steal/failover) land on the "front-door"
        # lane.  Sharing also keeps span ids unique fleet-wide.
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.sigma = SigmaRegistry() if sigma_registry is None \
            else sigma_registry
        self.work_stealing = work_stealing
        self.steal_min_backlog = steal_min_backlog
        self.steals = 0
        self.failovers = 0
        self.checkpoint_dir = checkpoint_dir
        # every replica loop beats this once per iteration; a replica whose
        # beat goes stale past the timeout (or whose .error is set — the
        # fast path for in-process deaths) is declared dead by
        # maybe_failover and its tenants move to a successor
        self.heartbeat = Heartbeat(timeout_s=heartbeat_timeout_s)
        self._failed: set[str] = set()
        self._alock = threading.RLock()
        self._assign: dict[str, AsyncJoinServer] = {}
        self.replicas: list[AsyncJoinServer] = []
        for i in range(replicas):
            if engine_factory is not None:
                eng = engine_factory(i)
                eng.sigma = self.sigma        # shared: see class docstring
            else:
                eng = JoinServer(sigma_registry=self.sigma, **engine_kw)
            # the replicas share one card: together their steps may plan
            # for one engine's share of it (slot_budget)
            if eng.memory_share is None:
                eng.memory_share = join_serve.SLOT_MEMORY_SHARE / replicas
            if tracer is not None:
                eng.tracer = tracer
            ckdir = os.path.join(checkpoint_dir, f"replica{i}") \
                if checkpoint_dir is not None else None
            self.replicas.append(AsyncJoinServer(
                eng, name=f"replica{i}", linger_s=linger_s, front_door=self,
                checkpoint_dir=ckdir, checkpoint_every_s=checkpoint_every_s,
                heartbeat=self.heartbeat))

    def submit(self, req: JoinRequest) -> Future:
        """Route by tenant and enqueue.  The routing lock is held through
        the replica enqueue so a submission can never race a steal of its
        own tenant onto the wrong replica (reordering same-id requests)."""
        req._ingest_t = time.perf_counter()
        with self._alock:
            self.maybe_failover()
            return self._route(tenant_of(req.query_id)).submit(req)

    def push(self, name: str, rels: Sequence[Relation]) -> list[Future]:
        """Push a micro-batch to stream ``name`` wherever its session lives
        NOW — on the opening replica, or on the failover successor that
        adopted it.  The crash-safe way to feed a stream: unlike holding the
        ``(replica, session)`` pair from :meth:`open_stream`, this re-routes
        after a failover."""
        with self._alock:
            self.maybe_failover()
            rep = self._route(name)
        return rep.push_by_name(name, rels)

    def submit_plan(self, plan, *, query_id: str = "plan0", **kw) -> dict:
        """Route a whole plan to its tenant's replica (the plan id IS the
        tenant, and every node's query id shares it — one plan never splits
        across replicas); returns node name -> future."""
        with self._alock:
            self.maybe_failover()
            rep = self._route(tenant_of(query_id))
        return rep.submit_plan(plan, query_id=query_id, **kw)

    def open_stream(self, name: str, spec, **kw):
        """Open a streaming session on the tenant's replica; returns
        ``(replica, session)`` — push via ``replica.push(session, ...)``.
        The tenant is pinned (never stolen) for the session's life."""
        with self._alock:
            rep = self._route(name)
        return rep, rep.open_stream(name, spec, **kw)

    def register_dataset(self, name: str, rels: Sequence[Relation]) -> None:
        """Broadcast: a stolen tenant's follow-up queries must resolve the
        handle wherever they land."""
        futs = [rep.call(partial(rep.engine.register_dataset, name, rels))
                for rep in self.replicas]
        for f in futs:
            f.result()

    def _live(self) -> list[AsyncJoinServer]:
        return [r for r in self.replicas
                if r.error is None and r.name not in self._failed]

    def _route(self, tenant: str) -> AsyncJoinServer:
        rep = self._assign.get(tenant)
        if rep is None or rep.error is not None or rep.name in self._failed:
            rep = min(self._live(), key=lambda r: r.backlog())
            self._assign[tenant] = rep
        return rep

    # -- failover -----------------------------------------------------------

    def maybe_failover(self, *, blocking: bool = True,
                       now: Optional[float] = None) -> int:
        """Detect dead replicas and fail each over; returns how many moved.

        Death = replica ``.error`` set (the in-process fast path: the loop
        thread died) OR its heartbeat stale past the timeout with the loop
        thread actually gone.  The thread-liveness conjunct matters: a
        replica mid-compile holds the engine lock for seconds without
        beating, and failing over a replica that is merely slow would fork
        its tenants' state (in a real multi-host deployment there is no
        thread handle and the stale beat alone decides — after a fencing
        step this test setup doesn't need).  Replica loops call this every
        iteration with ``blocking=False`` — a loop must never block on the
        routing lock while another thread holding it waits on that loop
        (the ``call()`` rendezvous in ``_failover``)."""
        if blocking:
            self._alock.acquire()
        elif not self._alock.acquire(blocking=False):
            return 0
        try:
            stale = set(self.heartbeat.dead_hosts(now))
            dead = [r for r in self.replicas if r.name not in self._failed
                    and (r.error is not None
                         or (r.name in stale
                             and not r._thread.is_alive()))]
            return sum(1 for r in dead if self._failover(r))
        finally:
            self._alock.release()

    def _failover(self, dead: AsyncJoinServer) -> bool:
        """Adopt ``dead``'s tenants onto a successor (caller holds _alock).

        The successor restores the dead replica's newest complete engine
        checkpoint (:func:`~repro_torch.runtime.fault.elastic_restore_engine`,
        merge semantics, onto ``self.device``) ON ITS LOOP THREAD, then
        inherits every tenant assignment.  Requests admitted after the
        last checkpoint are the loss window — their futures already
        failed with the replica's
        error, so callers know to resubmit; with ``checkpoint_every_s=0``
        the window is empty at every step boundary."""
        if dead.name in self._failed:
            return False
        alive = [r for r in self._live() if r is not dead]
        if not alive:
            return False        # nobody left to adopt; keep it failable
        self._failed.add(dead.name)
        successor = min(alive, key=lambda r: r.backlog())
        if dead._ckpt_writer is not None:
            dead._ckpt_writer.join()       # let the final write finish
        if dead.checkpoint_dir is not None:
            # tenants the front door moved off the dead replica (steals)
            # after its last checkpoint: their thief serves them
            gone = {t for t, rep in self._assign.items() if rep is not dead}
            restore = partial(self._restore_onto, dead.checkpoint_dir,
                              successor.engine, gone)
            if threading.current_thread() is successor._thread:
                # the successor's own loop detected the death: run inline
                # (a call() rendezvous with yourself never returns)
                with successor._elock:
                    restore()
            else:
                successor.call(restore).result()
        moved = 0
        for tenant, rep in list(self._assign.items()):
            if rep is dead:
                self._assign[tenant] = successor
                moved += 1
        if dead.engine.mesh is not None:
            # the dead replica's loop has left (its error is set): drop its
            # server's state on the ranks
            dead._thread.join(timeout=60)
            dead.engine.shutdown()
        self.failovers += 1
        self.tracer.instant("failover", cat="fleet", tid="front-door",
                            dead=dead.name, successor=successor.name,
                            tenants=moved)
        return True

    def _restore_onto(self, ckpt_dir: str, engine: JoinServer,
                      gone: set) -> None:
        """Restore a dead replica's newest checkpoint into ``engine`` (on
        ``self.device``, and on the engine's mesh), then drop the restored
        requests of the ``gone`` tenants, and their plan handles.  Their
        sigmas keep the shared registry's values, which are never older
        than the checkpoint's."""
        before = set(map(id, engine.queue))
        sigmas = {q: t for q, t in engine.sigma.table.items()
                  if tenant_of(q) in gone}
        elastic_restore_engine(ckpt_dir, engine, device=self.device)
        for q in [q for q in engine.sigma.table if tenant_of(q) in gone]:
            if q in sigmas:
                engine.sigma.table[q] = sigmas[q]
            else:
                del engine.sigma.table[q]
        stale = [r for r in engine.queue if id(r) not in before
                 and tenant_of(r.query_id) in gone]
        if not stale:
            return
        drop = set(map(id, stale))
        engine.queue = [r for r in engine.queue if id(r) not in drop]
        for r in stale:
            engine._release_request_words(r)
            handle = engine.plans.get(r.plan) if r.plan is not None \
                else None
            if handle is not None and all(
                    id(q) in drop for q in handle.requests.values()):
                del engine.plans[r.plan]

    def _steal_for(self, thief: AsyncJoinServer) -> bool:
        """Move one whole tenant from the most backed-up replica to an idle
        ``thief``.  Returns True if work moved.  Non-blocking on the
        routing lock: the thief is a loop thread, and a loop thread parked
        on ``_alock`` while its holder waits on that loop's ``call()``
        queue would deadlock the pair — skipping a steal round is free."""
        if not self.work_stealing or len(self.replicas) < 2:
            return False
        if not self._alock.acquire(blocking=False):
            return False
        try:
            for victim in sorted((r for r in self._live() if r is not thief),
                                 key=lambda r: -r.backlog()):
                if victim.backlog() < self.steal_min_backlog:
                    break
                got = victim._release_one_tenant()
                if got is None:
                    continue
                tenant, admitted, ingress_items = got
                self._assign[tenant] = thief
                thief._accept_stolen(admitted, ingress_items)
                self.steals += 1
                self.tracer.instant(
                    "steal", cat="fleet", tid="front-door", tenant=tenant,
                    victim=victim.name, thief=thief.name,
                    moved=len(admitted) + len(ingress_items))
                return True
        finally:
            self._alock.release()
        return False

    def snapshot(self) -> dict:
        return {"steals": self.steals, "failovers": self.failovers,
                "failed": sorted(self._failed),
                "tenants": {t: rep.name for t, rep in self._assign.items()},
                "replicas": {rep.name: rep.snapshot()
                             for rep in self.replicas}}

    def close(self, drain: bool = True, timeout: float = 60.0) -> None:
        for rep in self.replicas:
            rep.close(drain=drain, timeout=timeout)

    def __enter__(self) -> "AsyncJoinFrontDoor":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))
