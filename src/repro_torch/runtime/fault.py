"""Fault tolerance: step retries, straggler detection, restore after a
replica's death.

Failures are *injected* in the tests and drills (one process), and the
paths below are the ones a real death takes:

* **step retry**: ``guarded_step`` retries a failed step call with
  exponential backoff.  It catches ``Exception``: a CUDA error raised at a
  synchronize is one, but a device-side fault leaves the process's CUDA
  context unusable, so a retry, or a successor in the same process, cannot
  serve after it.
* **straggler mitigation**: ``StragglerMonitor`` tracks per-host step wall
  times (EWMA); hosts slower than ``threshold x`` the fleet median are
  flagged.
* **restore**: ``elastic_restore`` loads the newest checkpoint into a
  tree's structure on a chosen device; ``elastic_restore_engine`` hands a
  dead replica's newest engine checkpoint to a successor engine.
* **heartbeats**: ``Heartbeat`` timestamps; ``dead_hosts`` after a timeout.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.runtime.checkpoint import (latest_step, load_checkpoint,
                                            restore_checkpoint)


class InjectedFault(BaseException):
    """A deliberately injected replica death (``--kill-after`` fault drills).

    Subclasses ``BaseException`` so it sails past ``guarded_step``'s retry
    loop and the engine's own ``except Exception`` guards: an injected kill
    must take the replica down the same way a real process death would, not
    be absorbed by a retry."""


def guarded_step(step_fn: Callable, state, batch, *, retries: int = 2,
                 backoff_s: float = 0.0, on_failure: Optional[Callable] = None):
    """Run a step; on exception, retry (bounded).

    ``backoff_s`` > 0 sleeps ``backoff_s * 2**attempt`` between retries
    (exponential), giving a flaky device or filesystem time to recover
    instead of burning all retries in microseconds.  ``on_failure`` is
    shielded: an exception inside the callback is swallowed so it can never
    mask the real step error."""
    last = None
    for attempt in range(retries + 1):
        try:
            return step_fn(state, batch)
        except Exception as e:  # noqa: BLE001 (device errors surface so)
            last = e
            if on_failure is not None:
                try:
                    on_failure(attempt, e)
                except Exception:  # noqa: BLE001 (never mask the step error)
                    pass
            if backoff_s > 0.0 and attempt < retries:
                time.sleep(backoff_s * (2.0 ** attempt))
    raise RuntimeError(f"step failed after {retries + 1} attempts") from last


@dataclass
class Heartbeat:
    timeout_s: float = 30.0
    last_seen: dict = field(default_factory=dict)

    def beat(self, host: str, now: Optional[float] = None) -> None:
        self.last_seen[host] = time.monotonic() if now is None else now

    def dead_hosts(self, now: Optional[float] = None) -> list[str]:
        now = time.monotonic() if now is None else now
        return [h for h, t in self.last_seen.items()
                if now - t > self.timeout_s]


@dataclass
class StragglerMonitor:
    threshold: float = 2.0      # x median
    alpha: float = 0.3          # EWMA
    ewma: dict = field(default_factory=dict)

    def record(self, host: str, step_time_s: float) -> None:
        prev = self.ewma.get(host, step_time_s)
        self.ewma[host] = (1 - self.alpha) * prev + self.alpha * step_time_s

    def stragglers(self) -> list[str]:
        if len(self.ewma) < 2:
            return []
        times = sorted(self.ewma.values())
        mid = len(times) // 2
        # true median: the two middle elements' mean for an even-length
        # fleet (times[mid] alone over-reports and hides real stragglers)
        median = times[mid] if len(times) % 2 else \
            0.5 * (times[mid - 1] + times[mid])
        return [h for h, t in self.ewma.items()
                if t > self.threshold * median]


def elastic_restore(ckpt_dir: str, like_state, *, device=None):
    """Resume from the newest checkpoint, every leaf a tensor on ``device``
    (the card unless the caller asks for the CPU).

    Returns (state, step, extra) or (like_state, 0, {}) when no checkpoint
    exists (cold start)."""
    step = latest_step(ckpt_dir)
    if step is None:
        return like_state, 0, {}
    state, extra = restore_checkpoint(ckpt_dir, step, like_state,
                                      device=device)
    return state, step, extra


def elastic_restore_engine(ckpt_dir: str, engine, *,
                           device=None) -> Optional[int]:
    """Adopt a replica's newest engine checkpoint into ``engine``, its
    tensors on ``device`` (the card unless the caller asks for the CPU).

    Engine snapshots are structure-free (queue depth, dataset sizes and
    session buffers are whatever they were at capture), so the restore goes
    through ``load_checkpoint`` + ``engine.restore_state``: merge semantics,
    the failover successor path.  Returns the restored step, or None when
    the directory holds no complete checkpoint (nothing to adopt)."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    flat, extra = load_checkpoint(ckpt_dir, step)
    engine.restore_state(flat, extra, device=device)
    return step
