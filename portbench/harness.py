"""One run of one cell of the port's benchmark.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration, whose file holds the data's sizes and the deployment's
settings, and a traffic mix, ``portbench/traffic/<traffic>.json``, whose
``kind`` names the client pattern that reads it,
``portbench/traffic/<kind>.py``; ``portbench/workloads/<cell>.json`` holds
the limits of the numbers that decide ``correct``.  Each metric is read by
its own reader, ``portbench/metrics/<metric>.py``, from the run's
:class:`Records`.

A run: the client pattern makes the program's server and registers the
configuration's datasets, made on the device from the seed; its warm-up
ends set-up; then its window runs for ``seconds``, and what is still queued
at the close is served after it and checked, not timed.  Once the program
is freed, the plain reference works every answer out again and
:mod:`portbench.verify` compares.  With ``trace`` the program's ``Tracer``
records the window and ``torch.profiler`` a few steady steps of it.

A client pattern may start processes of its own, as a cell over several
cards does: its mesh starts in the pattern, one process a rank, and the
harness stays unaware of ranks.  Such a pattern's ``Clients`` gives two
hooks, which a pattern without them (``closed_loop.py``) goes without:
``peaks()``, called right after ``window()`` returns, lists the window's
peak allocated bytes of each card its processes hold (their peak statistics
reset as its window starts), and the run reports the fullest card's, its
own or theirs; ``close()``, called exactly once, after ``drain()`` or after
``warm``, ``window`` or ``drain`` raised, and before the reference runs,
stops those processes and frees their cards.  The profiler traces the
harness's own process alone, which is rank 0's: a multi-card cell's
``device_idle_pct``, device operations and kernels' rooflines are rank
0's card.
"""

from __future__ import annotations

import importlib.util
import json
import math
import re
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from portbench import verify
from portbench.generators import generate, sub_seed
from portbench.reference import join as ref_join
from portbench.yardstick import busy_seconds, edge_sample_gathered, idle_gaps

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# the profiler range around the profiled steps
MARK = "portbench.window"
# a traced run profiles about its window's last PROFILE_STEPS steps, and
# none of its first PROFILE_AFTER
PROFILE_STEPS, PROFILE_AFTER = 6, 3
# the clock check's kernel, in cycles: about 20 ms on an H100
CAL_CYCLES = 40_000_000
# a traced run whose clock check's kernel lasts, by the profiler's trace,
# more than this share off its length by CUDA events is refused: the trace
# reads it 1.5-4% short on an H100 in every run, and once read it at half
CLOCK_TOLERANCE = 0.2


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    datasets: int        # the configuration's datasets (``datasets``, 1)
    end_to_end: list     # manifest entries of the metrics a --trace 0 run reports
    per_layer: list      # ... and a --trace 1 run
    bench: Path


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    w = cells[name]
    files = {c["name"]: c["file"] for c in manifest["configs"]}
    bench = root / manifest["paths"][0]
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    config = json.loads((root / files[w["config"]]).read_text())
    return Cell(name, config,
                json.loads((bench / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
                json.loads((bench / "workloads" / f"{name}.json")
                           .read_text())["limits"],
                int(w["chips"]), int(config.get("datasets", 1)), e2e,
                per_layer, bench)


def _module(bench: Path, folder: str, name: str):
    path = bench / folder / f"{name}.py"
    if not NAME.match(name) or not path.is_file():
        raise ValueError(f"no {folder} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{folder}." + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(bench: Path, metric: str):
    """The ``read(records)`` function of ``metrics/<metric>.py``."""
    return _module(bench, "metrics", metric).read


def client_pattern(cell: Cell):
    """The module ``traffic/<kind>.py`` of the cell's mix: its
    ``Clients(ctx)`` makes the program's server and drives it (``warm``,
    ``window``, ``drain``, and where it starts processes ``peaks`` and
    ``close``: see the module's docstring); its ``planned(cell, seed, n)``
    lists the requests a run sends, and ``filter_seed(seed)`` is the
    filter-hash seed of a run's requests."""
    return _module(cell.bench, "traffic", cell.traffic["kind"])


def dataset_inputs(cell: Cell, seed: int, i: int, device) -> list:
    """Dataset ``i`` of the cell's configuration, made from the seed
    (the first from the seed itself)."""
    return generate(cell.config, seed if i == 0
                    else sub_seed(seed, "dataset", i), device)


class Context(NamedTuple):
    """What a client pattern is given: ``inputs(i)`` makes dataset ``i``."""

    cell: Cell
    seed: int
    device: str
    inputs: object
    tracer: object


class Records(NamedTuple):
    """What a run leaves for the metric readers.

    ``requests``: one dict a request answered in the window (``queue_s``, the
    program's ingest-to-dispatch time, and ``e2e_s``, submit to the answer on
    the host); ``steps``: one dict a window step (``served``);
    ``peak_bytes``: the window's peak allocated bytes of the fullest card
    (0 off a card); ``events``: the
    program's Tracer events of the window (traced runs); ``device``: the
    profiled steps (traced runs on a card): ``lo``/``hi`` (seconds, profiler
    clock), ``ops`` ((name, start, end) of each device operation) and
    ``steps`` (each profiled step's ``width``, ``caps``, ``num_blocks``,
    ``max_strata`` and, when it sampled, the value bytes its draws
    ``gathered``).
    """

    setup_s: float
    window_s: float
    requests: list
    steps: list
    peak_bytes: int
    events: list
    device: Optional[dict]


class Profile:
    """torch.profiler over about ``steps`` window steps, at least ``after``
    steps into the window."""

    def __init__(self, after: int, steps: int, cuda: bool):
        self.after, self.steps, self.cuda = after, steps, cuda
        self.prof = self.mark = None
        self.done = False
        self.t_pc = self.cal_s = 0.0
        self.scale: Optional[float] = None
        self.step_info: list = []
        self.result: Optional[dict] = None

    def _activities(self) -> list:
        from torch.profiler import ProfilerActivity
        return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.cuda else [])

    def warm(self) -> None:
        """Profile nothing once (set-up): the first session on a card starts
        its tracing library, which takes seconds."""
        from torch.profiler import profile
        with profile(activities=self._activities()):
            torch.zeros(1, device="cuda" if self.cuda else "cpu").add_(1)
            if self.cuda:
                torch.cuda.synchronize()

    def begin(self) -> None:
        from torch.profiler import profile, record_function
        self.prof = profile(activities=self._activities())
        self.prof.__enter__()
        if self.cuda:
            torch.cuda.synchronize()
        self.mark = record_function(MARK)
        self.mark.__enter__()
        self.t_pc = time.perf_counter()

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.done

    def end(self) -> None:
        """Stop profiling; the trace is read later.  On a card one kernel,
        timed by CUDA events, runs last, outside the marked range: the clock
        check of :meth:`read`.  (Events, not the host clock: waiting for the
        card under the profiler can take milliseconds more.)"""
        if self.cuda:
            torch.cuda.synchronize()
        self.mark.__exit__(None, None, None)
        if self.cuda:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            torch.cuda._sleep(CAL_CYCLES)
            b.record()
            b.synchronize()
            self.cal_s = a.elapsed_time(b) / 1e3
        t = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.stop_s = time.perf_counter() - t
        self.done = True

    def read(self) -> None:
        """Read the stopped profiler's trace (after the window).  A trace
        whose device times run at another rate than the card's own timer
        (seen once in seven traced runs, at half) is refused: the clock
        check's kernel has to last as long by both."""
        from torch.autograd import DeviceType
        events = self.prof.events()
        win = next(e for e in events if e.name == MARK
                   and e.device_type == DeviceType.CPU)
        lo, hi = win.time_range.start / 1e6, win.time_range.end / 1e6
        dev = [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
               for e in events if e.device_type == DeviceType.CUDA
               and e.name != MARK
               and not getattr(e, "is_user_annotation", False)]
        cal = [(a, b) for name, a, b in dev if "spin_kernel" in name]
        # the marker's own span on the device timeline is no device work,
        # nor is the clock check's kernel, which runs after the marker
        ops = [x for x in dev if "spin_kernel" not in x[0]]
        if self.cuda:
            self.scale = self.cal_s / max(cal[-1][1] - cal[-1][0], 1e-9) \
                if cal else math.nan
            if not abs(self.scale - 1) <= CLOCK_TOLERANCE:
                raise RuntimeError(
                    f"the profiler's device clock disagrees with CUDA "
                    f"events: events over trace {self.scale} for the clock "
                    f"check's kernel; the traced run reports nothing")
        steps = []
        for info in self.step_info:
            g = info.pop("draws", None)
            if g is not None:
                info["gathered"] = sum(edge_sample_gathered(
                    n.cpu().numpy(), list(c.cpu().numpy()), j.cpu().numpy())
                    for n, c, j in g)
            steps.append(info)
        self.result = {"lo": lo, "hi": hi, "ops": ops, "steps": steps,
                       "offset": self.t_pc - lo}
        self.prof = self.mark = None


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             *, device="cuda", t_start: Optional[float] = None,
             log=lambda *a: print(*a, file=sys.stderr, flush=True)) -> dict:
    """Run cell ``name`` once; returns the result line's dict."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(root, name)
    from repro_torch.runtime.telemetry import Tracer

    cfg, tr, q = cell.config, cell.traffic, cell.config["query"]
    cuda = torch.device(device).type == "cuda"
    pattern = client_pattern(cell)
    marks = [("imports", time.perf_counter())]
    tracer = Tracer(enabled=False)
    clients = pattern.Clients(Context(
        cell, seed, device,
        lambda i: dataset_inputs(cell, seed, i, device), tracer))
    try:
        _sync(device)
        marks.append(("inputs and registration", time.perf_counter()))
        clients.warm()
        _sync(device)
        marks.append(("warm-up", time.perf_counter()))
        profile = Profile(PROFILE_AFTER, PROFILE_STEPS, cuda) if trace \
            else None
        if profile is not None:
            profile.warm()
            marks.append(("profiler", time.perf_counter()))
        setup_s = time.perf_counter() - t_start
        parts = ", ".join(
            f"{k} {t - marks[i - 1][1] if i else t - t_start:.3f}"
            for i, (k, t) in enumerate(marks))
        log(f"portbench: {name} set up in {setup_s:.3f} s ({parts})")

        if cuda:
            torch.cuda.reset_peak_memory_stats()
        tracer.enabled = trace
        window_s = clients.window(seconds, profile)
        tracer.enabled = False
        peaks = getattr(clients, "peaks", None)
        peak = max([torch.cuda.max_memory_allocated() if cuda else 0,
                    *(peaks() if peaks is not None else ())])
        events = list(tracer.events)
        clients.drain()
    finally:
        if hasattr(clients, "close"):
            clients.close()
    for a in clients.answers:
        if "detail" in a:
            a["detail"] = {k: v.cpu().numpy() for k, v in a["detail"].items()}
    if profile is not None and profile.done:
        profile.read()
        log(f"portbench: profiled {len(profile.result['steps'])} steps, "
            f"{len(profile.result['ops'])} device operations; stopping the "
            f"profiler took {profile.stop_s:.3f} s; the clock check's kernel, "
            f"events over trace: {profile.scale}")
    st = np.diff([x["t0"] for x in clients.steps]) \
        if len(clients.steps) > 1 else np.zeros(1)
    log(f"portbench: {len(clients.requests)} answers in {window_s:.3f} s "
        f"({len(clients.steps)} steps, step to step quartiles "
        f"{np.round(np.percentile(st, [25, 50, 75]) * 1e3, 1).tolist()} ms), "
        f"{len(clients.answers)} checked")

    answers, sent, attempted = clients.answers, clients.sent, \
        clients.attempted
    records = Records(setup_s, window_s, clients.requests, clients.steps,
                      peak, events,
                      profile.result if profile is not None else None)
    if records.device is not None:
        records.device["spans"] = _host_spans(events, clients.client_spans)
    del clients, tracer, profile
    if cuda:
        torch.cuda.empty_cache()

    preps = [ref_join.prepare(dataset_inputs(cell, seed, i, device),
                              fp_rate=q["fp_rate"],
                              max_strata=q["max_strata"],
                              filter_seed=pattern.filter_seed(seed))
             for i in range(cell.datasets)]
    values = verify.numbers(preps, tr["queries"], sent, answers, attempted,
                            b_max=q["b_max"])
    correct, checks = verify.judge(values, cell.limits)
    if "sampled" in verify.kinds(tr["queries"]):
        log(f"portbench: the widest gap to the true SUM: "
            f"{verify.widest_truth_gap(preps, sent, answers)} bounds")

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(cell.bench, m["name"])(records)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": attempted - len(answers), "metrics": metrics,
              "device": dev}
    if records.device is not None:
        d = records.device
        dev["busy_s"] = _busy(d)
        dev["window_s"] = d["hi"] - d["lo"]
        result["breakdown"] = _breakdown(d)
    result["checks"] = {k: {"value": _num(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}
    return result


def _busy(d: dict) -> float:
    return busy_seconds([(a, b) for _, a, b in d["ops"]], d["lo"], d["hi"])


def _host_spans(events: list, client_spans: list) -> list:
    """(name, start, end, depth) of what the host did, perf_counter clock:
    every span of the program's engine lane, its depth the number of engine
    spans that hold it, found by time (``to-host`` is a child of ``step``
    after ``prepare`` and a grandchild inside ``finish``), and the
    benchmark's own client work."""
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e["tid"] == "engine" and e["dur"]),
                   key=lambda s: (s[0], -s[1]))
    out, holders = [], []       # the ends of the spans holding the next
    for a, b, name in spans:
        while holders and holders[-1] < b:
            holders.pop()
        out.append((name, a, b, len(holders)))
        holders.append(b)
    out += [("client", a, b, 0) for a, b in client_spans]
    return out


def _breakdown(d: dict) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing (the innermost span over each gap's middle)."""
    by_op: dict = {}
    for name, a, b in d["ops"]:
        by_op[name] = by_op.get(name, 0.0) + (b - a)
    idle: dict = {}
    for a, b in idle_gaps([(x, y) for _, x, y in d["ops"]], d["lo"], d["hi"]):
        t = (a + b) / 2 + d["offset"]
        cover = [(s[3], s[0]) for s in d.get("spans", []) if s[1] <= t <= s[2]]
        name = max(cover)[1] if cover else "other"
        if name == "step":
            name = "step.host"
        idle[name] = idle.get(name, 0.0) + (b - a)

    def top(dct):
        return [[k[:120], v] for k, v in
                sorted(dct.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(idle)}


def _num(v):
    """A JSON-safe number: inf and NaN as strings."""
    if isinstance(v, float) and not math.isfinite(v):
        return str(v)
    return v
