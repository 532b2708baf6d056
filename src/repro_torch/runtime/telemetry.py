"""Unified telemetry: span tracing, a metrics registry, byte reconciliation.

The port's own copy of the JAX package's telemetry layer (it needs numpy
only), with the same names, schema and output formats, so a trace or a
metrics dump from either package reads the same.  Three cooperating pieces,
shared by the serving layers (`JoinServer` now; the streaming and async
tiers when they are ported):

* `Tracer` — per-query spans (ingest, batch-formation, compile, prepare,
  sample / exact, complete) and the served step's host spans on the engine
  lane (batch-inputs, to-host, decide with its sigma-lookups, finish with
  its sigma-updates) recorded into a bounded ring.  Disabled tracers cost
  one attribute read per call site (`span()` hands back a shared no-op
  span; `instant()`/`event()` return immediately), so the hot path is
  unchanged with tracing off.  While a `torch.profiler` session runs, an
  enabled tracer's live spans also open `record_function` ranges of their
  names, so the profiler's trace carries them on its own clock; the ranges
  record nothing in the ring.  Rings export as Chrome trace-event JSON
  (`chrome_trace`) viewable in Perfetto / chrome://tracing, tagged with
  replica identity.

* `MetricsRegistry` — named counters / gauges / histograms.  The server
  diagnostics route their fields through one registry, which is therefore
  the single backing store for every snapshot dict, and exports as JSON
  (`to_dict`) or Prometheus text exposition format (`prometheus`).

* Byte reconciliation — per-query records pairing each modeled cost
  (`filter_exchange_bytes`, the live-tuple bytes of §3.1) with its metered
  counterpart where the serving path has a meter, and the relative model
  error, aggregated per serving path by `reconciliation_report`.

The span-id sequence is the tracer state a successor server must carry on
(`Tracer.state()`/`Tracer.adopt()`), so that its spans never reuse ids.
"""
from __future__ import annotations

import json
import re
import sys
import threading
from collections import OrderedDict, deque
from time import perf_counter
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------


class Counter:
    """Monotonic-by-convention numeric cell (restore may add, never read-modify
    concurrently without the caller's lock — same contract the diagnostics
    counters always had)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Any = 0

    def inc(self, v: Any = 1) -> None:
        self.value += v


class Gauge:
    """Point-in-time value; may hold a scalar or a numpy vector (per-device
    meters).  `None` means never set."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Any = None

    def set(self, v: Any) -> None:
        self.value = v


class Histogram:
    """Bounded sample ring plus cumulative count/sum.  The ring keeps the most
    recent `cap` observations (the percentile window); count/total never
    reset, so rates stay meaningful across `reset_latencies()`."""

    __slots__ = ("name", "cap", "samples", "count", "total")

    def __init__(self, name: str, cap: int = 4096):
        self.name = name
        self.cap = int(cap)
        self.samples: List[float] = []
        self.count = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        s = self.samples
        s.append(v)
        if len(s) > self.cap:
            del s[: len(s) - self.cap]

    def reset_samples(self) -> None:
        del self.samples[:]

    def percentiles(self, prefix: str) -> Dict[str, float]:
        return latency_pcts(self.samples, prefix)


def latency_pcts(samples: Sequence[float], prefix: str) -> Dict[str, float]:
    """p50/p95/max summary with a stable key schema — the one helper behind
    both `ServerDiagnostics` and `StreamDiagnostics` snapshots."""
    if len(samples):
        arr = np.asarray(samples, np.float64)
        return {f"{prefix}_p50_s": float(np.percentile(arr, 50)),
                f"{prefix}_p95_s": float(np.percentile(arr, 95)),
                f"{prefix}_max_s": float(arr.max())}
    return {f"{prefix}_p50_s": 0.0, f"{prefix}_p95_s": 0.0,
            f"{prefix}_max_s": 0.0}


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    name = _PROM_BAD.sub("_", name)
    return name if not name[:1].isdigit() else "_" + name


class MetricsRegistry:
    """Get-or-create store of named metrics.  Creating a name twice returns
    the same object; creating it as a different kind is an error (it would
    silently fork the backing store)."""

    def __init__(self):
        self._metrics: "OrderedDict[str, Any]" = OrderedDict()

    def _get(self, name: str, kind, *args):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = kind(name, *args)
        elif type(m) is not kind:
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {kind.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, cap: int = 4096) -> Histogram:
        return self._get(name, Histogram, cap)

    def __iter__(self):
        return iter(self._metrics.values())

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def to_dict(self) -> Dict[str, Any]:
        """JSON-able view: counters/gauges by value, histograms as summary
        dicts.  Read-only — building it mutates nothing."""
        out: Dict[str, Any] = {}
        for m in self._metrics.values():
            if isinstance(m, Histogram):
                out[m.name] = {"count": m.count, "total": m.total,
                               **m.percentiles("sample")}
            elif isinstance(m.value, np.ndarray):
                out[m.name] = [float(x) for x in m.value]
            else:
                out[m.name] = m.value
        return out

    def prometheus(self, prefix: str = "repro") -> str:
        """Prometheus text exposition format.  Histograms export as summaries
        (quantile labels over the bounded window + cumulative _count/_sum);
        vector gauges export one sample per index under a `device` label."""
        lines: List[str] = []
        for m in self._metrics.values():
            name = _prom_name(f"{prefix}_{m.name}" if prefix else m.name)
            if isinstance(m, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {float(m.value)}")
            elif isinstance(m, Gauge):
                if m.value is None:
                    continue
                lines.append(f"# TYPE {name} gauge")
                if isinstance(m.value, (np.ndarray, list, tuple)):
                    for i, x in enumerate(m.value):
                        lines.append(f'{name}{{device="{i}"}} {float(x)}')
                else:
                    lines.append(f"{name} {float(m.value)}")
            else:
                lines.append(f"# TYPE {name} summary")
                if len(m.samples):
                    arr = np.asarray(m.samples, np.float64)
                    for q in (0.5, 0.95, 0.99):
                        lines.append(f'{name}{{quantile="{q}"}} '
                                     f"{float(np.percentile(arr, 100 * q))}")
                lines.append(f"{name}_count {m.count}")
                lines.append(f"{name}_sum {float(m.total)}")
        return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------
# tracing
# --------------------------------------------------------------------------


class _NullSpan:
    """Shared no-op span — what a disabled tracer's `span()` returns, so call
    sites can unconditionally use `with tracer.span(...) as s`."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw) -> None:
        pass


NULL_SPAN = _NullSpan()


def _profiler_range(name: str):
    """An open `torch.profiler.record_function` range named `name` while a
    profiler session runs on this thread, else None.  Torch comes from
    `sys.modules`: a process that never imported it runs no profiler, and
    this module still imports with numpy alone."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    rng = torch.autograd.profiler.record_function(name)
    rng.__enter__()
    return rng


class Span:
    """Context manager recording one duration event on exit (``t0`` and
    ``dur`` stay on the span), mirrored as a profiler range of the same
    name while a profiler session runs."""

    __slots__ = ("_tracer", "name", "cat", "tid", "args", "t0", "dur",
                 "_range")

    def __init__(self, tracer: "Tracer", name: str, cat: str, tid: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name, self.cat, self.tid, self.args = name, cat, tid, args
        self.t0 = self.dur = 0.0
        self._range = None

    def set(self, **kw) -> None:
        self.args.update(kw)

    def __enter__(self):
        self._range = _profiler_range(self.name)
        self.t0 = perf_counter()
        return self

    def __exit__(self, *exc):
        self.dur = perf_counter() - self.t0
        if self._range is not None:
            self._range.__exit__(None, None, None)
        self._tracer.event(self.name, self.t0, self.dur, cat=self.cat,
                           tid=self.tid, **self.args)
        return False


class Tracer:
    """Bounded span/event ring with a monotone id sequence.

    Events are plain dicts (`id`, `name`, `cat`, `tid`, `ts`, `dur`, `args`)
    with seconds-since-perf_counter-epoch timestamps; `chrome_trace` converts
    to the Chrome trace-event JSON schema.  `tags` (e.g. replica name, mesh
    size) are merged into every event's args.  The id sequence is the only
    state that must survive failover — `state()`/`adopt()` round-trip it
    through engine snapshots so a successor never reuses a dead replica's
    span ids.
    """

    def __init__(self, enabled: bool = True, capacity: int = 65536,
                 tags: Optional[Dict[str, Any]] = None):
        self.enabled = enabled
        self.capacity = int(capacity)
        self.events: "deque[Dict[str, Any]]" = deque(maxlen=self.capacity)
        self.recon: "deque[Dict[str, Any]]" = deque(maxlen=self.capacity)
        self.tags = dict(tags or {})
        self._lock = threading.Lock()
        self._seq = 0

    # -- ids / crash-safety ------------------------------------------------

    def next_id(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def state(self) -> Dict[str, Any]:
        """JSON-able state for `snapshot_state` meta."""
        with self._lock:
            return {"seq": self._seq}

    def adopt(self, state: Dict[str, Any]) -> None:
        """Merge a snapshot's id sequence (max-merge: ids stay unique when a
        successor adopts a dead replica's state on top of its own)."""
        with self._lock:
            self._seq = max(self._seq, int(state.get("seq", 0)))

    # -- recording ---------------------------------------------------------

    def span(self, name: str, cat: str = "serve", tid: str = "engine",
             **args):
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, cat, tid, args)

    def event(self, name: str, ts: float, dur: float, cat: str = "serve",
              tid: str = "engine", **args) -> None:
        """Record a duration event with explicit perf_counter timestamps —
        for spans whose boundaries were stamped elsewhere (e.g. a query's
        ingest/dispatch/complete times stamped by the engine)."""
        if not self.enabled:
            return
        self.events.append({"id": self.next_id(), "name": name, "cat": cat,
                            "tid": tid, "ts": float(ts),
                            "dur": max(0.0, float(dur)),
                            "args": {**self.tags, **args}})

    def instant(self, name: str, cat: str = "serve", tid: str = "engine",
                ts: Optional[float] = None, **args) -> None:
        if not self.enabled:
            return
        self.events.append({"id": self.next_id(), "name": name, "cat": cat,
                            "tid": tid,
                            "ts": perf_counter() if ts is None else float(ts),
                            "dur": None, "args": {**self.tags, **args}})

    def note_recon(self, record: Dict[str, Any]) -> None:
        if self.enabled:
            self.recon.append(record)


#: Module-level disabled tracer — the default for every server, so call sites
#: never branch on `tracer is None`.  Never enable or `adopt()` onto it.
NULL_TRACER = Tracer(enabled=False, capacity=1)


# --------------------------------------------------------------------------
# chrome trace export
# --------------------------------------------------------------------------


def chrome_trace(tracer: Tracer,
                 reconciliation: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
    """Render a tracer's ring as a Chrome trace-event JSON object.

    One pid per replica tag, one tid row per lane string; "M" metadata events
    name both so Perfetto shows readable tracks.  Extra top-level keys
    (`otherData`, `reconciliation`) are ignored by viewers but carried for
    `trace_dump`.
    """
    pids: Dict[str, int] = {}
    tids: Dict[Tuple[int, str], int] = {}
    evs: List[Dict[str, Any]] = []
    for e in tracer.events:
        proc = str(e["args"].get("replica", tracer.tags.get("replica",
                                                            "serve")))
        if proc not in pids:
            pids[proc] = pid = len(pids) + 1
            evs.append({"name": "process_name", "ph": "M", "pid": pid,
                        "tid": 0, "ts": 0,
                        "args": {"name": f"repro/{proc}"}})
        pid = pids[proc]
        lane = (pid, str(e["tid"]))
        if lane not in tids:
            tids[lane] = tid = len(tids) + 1
            evs.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid, "ts": 0, "args": {"name": lane[1]}})
        tid = tids[lane]
        ts_us = e["ts"] * 1e6
        args = {"span_id": e["id"], **e["args"]}
        if e["dur"] is None:
            evs.append({"name": e["name"], "cat": e["cat"], "ph": "i",
                        "ts": ts_us, "pid": pid, "tid": tid, "s": "t",
                        "args": args})
        else:
            evs.append({"name": e["name"], "cat": e["cat"], "ph": "X",
                        "ts": ts_us, "dur": e["dur"] * 1e6, "pid": pid,
                        "tid": tid, "args": args})
    out: Dict[str, Any] = {"traceEvents": evs, "displayTimeUnit": "ms",
                           "otherData": {"tags": dict(tracer.tags)}}
    if reconciliation is not None:
        out["reconciliation"] = reconciliation
    return out


def validate_chrome_trace(obj: Any) -> int:
    """Validate a Chrome trace-event JSON object; return the event count.

    Raises ValueError on schema violations (missing/ill-typed fields, events
    that would not load in Perfetto / chrome://tracing)."""
    if not isinstance(obj, dict) or not isinstance(obj.get("traceEvents"),
                                                   list):
        raise ValueError("trace must be a dict with a traceEvents list")
    for i, e in enumerate(obj["traceEvents"]):
        if not isinstance(e, dict):
            raise ValueError(f"event {i}: not a dict")
        ph = e.get("ph")
        if ph not in ("X", "i", "M"):
            raise ValueError(f"event {i}: unsupported ph {ph!r}")
        if not isinstance(e.get("name"), str):
            raise ValueError(f"event {i}: name must be a string")
        if not isinstance(e.get("pid"), int) or not isinstance(
                e.get("tid"), int):
            raise ValueError(f"event {i}: pid/tid must be ints")
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"event {i}: bad ts {ts!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: bad dur {dur!r}")
        if "args" in e and not isinstance(e["args"], dict):
            raise ValueError(f"event {i}: args must be a dict")
    json.dumps(obj)   # must be serializable end to end
    return len(obj["traceEvents"])


def dump_chrome_trace(tracer: Tracer, path: str,
                      reconciliation: Optional[Dict[str, Any]] = None) -> int:
    """Write (and validate) a chrome trace file; return the event count."""
    obj = chrome_trace(tracer, reconciliation=reconciliation)
    n = validate_chrome_trace(obj)
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)
    return n


def span_tree(events: Iterable[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Nest tracer-ring duration events by time containment on each lane.

    Returns a forest of `{"name", "cat", "ts", "dur", "args", "children"}`
    nodes — the per-query span tree when given one query's events (see
    `JoinServer.query_trace`)."""
    lanes: Dict[str, List[Dict[str, Any]]] = {}
    for e in events:
        if e.get("dur") is None:
            continue
        lanes.setdefault(str(e["tid"]), []).append(e)
    forest: List[Dict[str, Any]] = []
    for lane in lanes.values():
        lane.sort(key=lambda e: (e["ts"], -e["dur"], e["id"]))
        stack: List[Dict[str, Any]] = []
        for e in lane:
            node = {"name": e["name"], "cat": e["cat"], "ts": e["ts"],
                    "dur": e["dur"], "args": e["args"], "children": []}
            end = e["ts"] + e["dur"]
            eps = 1e-9
            while stack and end > stack[-1]["ts"] + stack[-1]["dur"] + eps:
                stack.pop()
            (stack[-1]["children"] if stack else forest).append(node)
            if e["dur"] > 0:     # zero-duration markers are always leaves
                stack.append(node)
    return forest


# --------------------------------------------------------------------------
# byte reconciliation
# --------------------------------------------------------------------------


def recon_pair(name: str, modeled: float,
               measured: Optional[float]) -> Dict[str, Any]:
    """One modeled-vs-metered byte pair.  `measured=None` means the path has
    no meter for this cost (e.g. single-device serving moves no wire bytes);
    rel_error is the signed relative model error against the meter."""
    rel = None
    if measured is not None and measured > 0:
        rel = (float(modeled) - float(measured)) / float(measured)
    return {"name": name, "modeled": float(modeled),
            "measured": None if measured is None else float(measured),
            "rel_error": rel}


def reconciliation_report(records: Iterable[Dict[str, Any]],
                          server_pairs: Optional[List[Dict[str, Any]]] = None
                          ) -> Dict[str, Any]:
    """Aggregate per-query reconciliation records into a per-path report.

    `records` come from `Tracer.recon` (one dict per traced query, with a
    `path` tag and a `pairs` list); `server_pairs` are cumulative
    server-level pairs (amortized costs that have no per-query meter, e.g.
    the filter exchange, which is cached across queries)."""
    records = list(records)
    paths: Dict[str, Dict[str, Dict[str, float]]] = {}
    for r in records:
        agg = paths.setdefault(r["path"], {})
        for p in r["pairs"]:
            a = agg.setdefault(p["name"],
                               {"queries": 0, "modeled": 0.0,
                                "measured": 0.0, "metered_queries": 0})
            a["queries"] += 1
            a["modeled"] += p["modeled"]
            if p["measured"] is not None:
                a["measured"] += p["measured"]
                a["metered_queries"] += 1
    for agg in paths.values():
        for a in agg.values():
            if a["metered_queries"]:
                a["rel_error"] = ((a["modeled"] - a["measured"])
                                  / max(a["measured"], 1e-12))
            else:
                a["measured"] = None
                a["rel_error"] = None
    return {"queries": records, "paths": paths,
            "server": list(server_pairs or [])}


def format_reconciliation(report: Dict[str, Any]) -> str:
    """Human-readable rendering of a reconciliation report."""
    lines = []
    for path, agg in sorted(report["paths"].items()):
        lines.append(f"path {path}:")
        for name, a in agg.items():
            err = ("n/a (unmetered)" if a["rel_error"] is None
                   else f"{100 * a['rel_error']:+.1f}%")
            meas = ("-" if a["measured"] is None
                    else f"{a['measured']:.0f}")
            lines.append(f"  {name:<24} modeled {a['modeled']:>12.0f}  "
                         f"measured {meas:>12}  model err {err}  "
                         f"({a['queries']} queries)")
    if report["server"]:
        lines.append("server (cumulative/amortized):")
        for p in report["server"]:
            err = ("n/a (unmetered)" if p["rel_error"] is None
                   else f"{100 * p['rel_error']:+.1f}%")
            meas = ("-" if p["measured"] is None
                    else f"{p['measured']:.0f}")
            lines.append(f"  {p['name']:<24} modeled {p['modeled']:>12.0f}  "
                         f"measured {meas:>12}  model err {err}")
    return "\n".join(lines) if lines else "(no reconciliation records)"
