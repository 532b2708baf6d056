"""Incremental windowing for streaming ApproxJoin (StreamApprox dataflow).

A stream is an unbounded sequence of per-tenant micro-batches; queries run
over **windows** measured in *sub-windows* (micro-batch slots of a fixed row
capacity).  ``WindowSpec(size, slide, sub_rows)`` covers both shapes the
streaming literature cares about:

* tumbling — ``slide == size``: consecutive disjoint windows;
* sliding  — ``slide < size``: window ``w`` spans sub-windows
  ``[w*slide, w*slide + size)``, so consecutive windows share
  ``size - slide`` sub-windows.

The key property this module exists for: a window's per-input Bloom filter
is the **OR of its sub-windows' filters** (scatter-OR is a set union, so the
OR of sub-window words is bit-identical to a from-scratch build over the
window's concatenated rows at the same geometry/seed).  Sub-window filter
words are therefore built once on arrival — cached by sub-window fingerprint
in the JoinServer's filter cache — OR-merged per emission, and simply left
out of the OR once the sub-window expires.  A slide never rebuilds the
filter of a surviving sub-window.

Everything here is host-side bookkeeping over fixed-capacity
:class:`~repro_torch.core.relation.Relation` slots; the device work (builds,
ORs, join stages) stays in the serving engine.
"""

from __future__ import annotations

from collections import deque
from typing import NamedTuple, Sequence

from repro_torch.core.relation import (Relation, bucket_capacity,
                                       concatenate, pad_to)


class WindowSpec(NamedTuple):
    """Window geometry in sub-window units.

    ``sub_rows`` is the per-side row capacity of ONE sub-window; a window's
    relations have ``size * sub_rows`` rows (pow2-bucketed at assembly).
    """

    size: int       # sub-windows per window
    slide: int      # sub-windows advanced per emission (== size: tumbling)
    sub_rows: int   # per-side row capacity of one sub-window

    @property
    def tumbling(self) -> bool:
        return self.slide == self.size

    def start(self, w: int) -> int:
        """First sub-window index of window ``w``."""
        return w * self.slide

    def end(self, w: int) -> int:
        """One past the last sub-window index of window ``w``."""
        return w * self.slide + self.size

    def validate(self) -> "WindowSpec":
        if not (1 <= self.slide <= self.size):
            raise ValueError(f"need 1 <= slide <= size, got {self}")
        if self.sub_rows < 1:
            raise ValueError(f"sub_rows must be positive, got {self}")
        return self


class SubWindow(NamedTuple):
    """One admitted micro-batch: bucketed relations + their fingerprints.

    ``fps`` key the per-sub-window filter-word cache — the identity that
    makes a slide reuse every surviving sub-window's build.
    """

    index: int
    rels: tuple
    fps: tuple


class WindowBuffer:
    """Host-side ring of live sub-windows with emission bookkeeping.

    ``push`` returns the windows that became due plus the sub-windows that
    expired (no longer reachable by ANY future window) — the caller retires
    the expired filter words.  Live occupancy is bounded by ``spec.size``.
    """

    def __init__(self, spec: WindowSpec):
        self.spec = spec.validate()
        self.live: deque = deque()
        self.arrived = 0          # sub-windows pushed so far
        self.emitted = 0          # windows emitted so far

    def push(self, sub: SubWindow):
        assert sub.index == self.arrived, (sub.index, self.arrived)
        self.live.append(sub)
        self.arrived += 1
        due, expired = [], []
        while self.arrived >= self.spec.end(self.emitted):
            start = self.spec.start(self.emitted)
            subs = [s for s in self.live if s.index >= start]
            assert len(subs) == self.spec.size, (len(subs), self.spec)
            due.append((self.emitted, subs))
            self.emitted += 1
            # retire everything no future window (>= emitted) can reach
            next_start = self.spec.start(self.emitted)
            while self.live and self.live[0].index < next_start:
                expired.append(self.live.popleft())
        return due, expired


def window_relations(subs: Sequence[SubWindow],
                     minimum: int = 1) -> list[Relation]:
    """Assemble a window's per-side relations from its sub-windows.

    Concatenation order is arrival order; the result is padded to the
    window's pow2 capacity bucket (invalid padding rows), at least
    ``minimum`` rows (a mesh server's size), so every window of a given spec
    lands in ONE serving shape class.
    """
    n_sides = len(subs[0].rels)
    cap = bucket_capacity(len(subs) * subs[0].rels[0].capacity, minimum)
    return [pad_to(concatenate([s.rels[side] for s in subs]), cap)
            for side in range(n_sides)]
