"""The port's examples against the JAX package's.

Each join example ``examples/torch_*.py`` runs whole with ``--device cpu``
in its own process and must print its own check; its exact SUM and join
size must equal, within rtol 1e-5, what the JAX example it ports computes
for them: the same exact query, with the example's arguments, through the
JAX package here (the JAX examples' sampled runs are not needed for it and
take half a minute on the CPU).  ``torch_train_lm.py --small`` (60 steps
here) must print the JAX example's batch mixture, the same per-batch counts
and its estimate and bound within rtol 1e-5, and a falling loss.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import QueryBudget, approx_join
from repro.core.relation import relation
from repro.data import tpch
from repro.data.flows import flow_tables
from repro.data.pipeline import mixture_shard_counts, plan_batch_mixture

ROOT = Path(__file__).resolve().parents[1]


def quickstart():
    """examples/quickstart.py's exact SUM."""
    rng = np.random.default_rng(0)
    N = 1 << 14
    r1 = relation(rng.integers(0, 1000, N).astype(np.uint32),
                  rng.normal(10.0, 2.0, N).astype(np.float32))
    r2 = relation(rng.integers(800, 1800, N).astype(np.uint32),
                  rng.normal(5.0, 1.0, N).astype(np.float32))
    return approx_join([r1, r2])


def network_flows():
    """examples/network_flows.py's exact 3-way SUM."""
    tcp, udp, icmp = flow_tables(scale=8192, shared_fraction=0.03, seed=7)
    return approx_join([icmp, udp, tcp], QueryBudget(), max_strata=8192)


def tpch_budget():
    """examples/tpch_budget.py's exact SUM."""
    t = tpch.generate(scale=0.01, seed=3)
    return approx_join(tpch.q_customer_orders(t), QueryBudget(),
                       max_strata=1 << 14)


EXAMPLES = {
    "quickstart": (quickstart, r"exact\s+SUM = (\S+)\s+join size = (\d+)"),
    "network_flows": (network_flows,
                      r"exact:\s+total bytes = (\S+)\s+\((\d+) joined"),
    "tpch_budget": (tpch_budget, r"exact SUM\(o_totalprice \+ c_acctbal\) = "
                                 r"(\S+)\s+join size = (\d+)"),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_port_example_equals_the_jax_example(name):
    reference, pattern = EXAMPLES[name]
    want = reference()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "4"}
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"torch_{name}.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("on cpu")
    assert "[OK]" in out.stdout
    m = re.search(pattern, out.stdout)
    assert m, out.stdout
    assert int(m.group(2)) == int(want.count)
    got, exact = float(m.group(1)), float(want.estimate)
    assert abs(got - exact) <= 1e-5 * abs(exact), (got, exact)


def test_train_example_mixture_equals_the_jax_examples_and_loss_falls():
    """examples/train_lm.py's mixture (its tables, budget and batch)
    through the JAX package, against the port's example run with --small
    --device cpu for 60 steps."""
    rng = np.random.default_rng(0)
    docs = relation(rng.integers(0, 16, 8192).astype(np.uint32),
                    rng.random(8192).astype(np.float32))
    domains = relation(np.arange(16, dtype=np.uint32),
                       np.ones(16, np.float32))
    plan = plan_batch_mixture(docs, domains, QueryBudget(error=0.05))
    counts = mixture_shard_counts(plan, batch=8).tolist()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "4"}
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_train_lm.py"),
         "--small", "--steps", "60", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("on cpu")
    m = re.search(r"\[mixture\] (\d+) domains via ApproxJoin \(estimate "
                  r"(\S+) \+/- (\S+)\); per-batch seq counts = (\[.*\])",
                  out.stdout)
    assert m, out.stdout
    assert int(m.group(1)) == len(plan.weights)
    assert m.group(4) == str(counts)
    for got, want in ((m.group(2), plan.estimate), (m.group(3),
                                                     plan.error_bound)):
        assert abs(float(got) - want) <= max(1e-5 * abs(want), 0.05)
    m = re.search(r"\[train_lm\] loss (\S+) -> (\S+) over 60 steps",
                  out.stdout)
    assert m and float(m.group(2)) < float(m.group(1)), out.stdout
    assert "[OK]" in out.stdout

