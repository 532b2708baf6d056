"""The CPU cuts of the configurations added after ``tests/conftest.py``'s
``TINY``: each is filled in there when that file loads, so that every test
file of ``portbench/tests`` runs alone too."""

from __future__ import annotations

from pathlib import Path

TESTS_CONFTEST = Path(__file__).resolve().parent / "tests" / "conftest.py"
# 16 movies, the largest strata about 4,000 x 20,001 edges (past 2^24), so a
# float32 population reads wrong on the CPU too
TINY = {
    "netflix-prize": {"rows": [20000, 100000], "movies": 16,
                      "top_count": 20001,
                      "query": {"fp_rate": 0.01, "max_strata": 64,
                                "b_max": 64, "batch_slots": 4}},
}


def pytest_plugin_registered(plugin, manager):
    path = getattr(plugin, "__file__", None)
    if path and Path(path).resolve() == TESTS_CONFTEST:
        for name, cut in TINY.items():
            plugin.TINY.setdefault(name, cut)
