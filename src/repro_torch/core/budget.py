"""Query budget interface (paper §2).

The paper's query surface is an aggregation over an n-way equi-join plus a
budget clause:

    SELECT SUM(R1.V + R2.V + ... + Rn.V)
    FROM R1, ..., Rn WHERE R1.A = ... = Rn.A
    WITHIN 120 SECONDS            -- latency budget, or
    ERROR 0.01 CONFIDENCE 95%     -- error budget

:class:`QueryBudget` is the structured form; :func:`parse_budget` accepts the
paper's textual clause for the examples.  ``None`` budget = exact join.
"""

from __future__ import annotations

import re
from typing import NamedTuple, Optional


class QueryBudget(NamedTuple):
    latency_s: Optional[float] = None   # WITHIN d SECONDS
    error: Optional[float] = None       # ERROR e
    confidence: float = 0.95            # CONFIDENCE c%
    pilot_fraction: float = 0.1         # first-run fraction when sigma unknown

    @property
    def is_exact(self) -> bool:
        return self.latency_s is None and self.error is None


_WITHIN = re.compile(r"WITHIN\s+([0-9.]+)\s*SECONDS?", re.I)
_ERROR = re.compile(r"ERROR\s+([0-9.]+)(?:\s+CONFIDENCE\s+([0-9.]+)\s*%)?",
                    re.I)


def parse_budget(clause: str) -> QueryBudget:
    """Parse the paper's budget clause text into a QueryBudget."""
    latency = error = None
    confidence = 0.95
    m = _WITHIN.search(clause)
    if m:
        latency = float(m.group(1))
    m = _ERROR.search(clause)
    if m:
        error = float(m.group(1))
        if m.group(2):
            confidence = float(m.group(2)) / 100.0
    if latency is None and error is None and clause.strip():
        raise ValueError(f"unrecognized budget clause: {clause!r}")
    return QueryBudget(latency, error, confidence)
