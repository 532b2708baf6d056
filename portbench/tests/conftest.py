"""Fixtures of the benchmark's CPU tests: a copy of the benchmark whose
configurations are cut to a size the CPU runs in seconds."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# the cut each configuration gets on the CPU (every other key kept), one
# file a configuration: cuts/<config>.json.  Netflix's keeps 16 movies, the
# largest strata about 4,000 x 20,001 edges (past 2^24), so a float32
# population reads wrong on the CPU too.
CUTS = Path(__file__).resolve().parent / "cuts"
TINY = {p.stem: json.loads(p.read_text())
        for p in sorted(CUTS.glob("*.json"))}


def tiny_tree(dest: Path) -> Path:
    """A root holding the benchmark with its configurations cut to TINY and
    each mix's verified sample drawn from the answers to the clients' first
    requests (a window on the CPU may answer few more).  A configuration
    with no cut file is refused."""
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in manifest["configs"]:
        if c["name"] not in TINY:
            raise FileNotFoundError(f"configuration {c['name']!r} has no CPU "
                                    f"cut: {CUTS / (c['name'] + '.json')}")
        path = dest / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(TINY[c["name"]])
        path.write_text(json.dumps(cfg))
    for path in (dest / "portbench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(verify_span=mix["clients"], verify_sample=4)
        path.write_text(json.dumps(mix))
    (dest / "BENCHMARK.json").write_text(json.dumps(manifest))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return tiny_tree(tmp_path)
