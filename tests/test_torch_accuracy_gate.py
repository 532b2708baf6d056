"""The statistical accuracy gate (``tests/torch_accuracy.py``) applied to the
port's single-device backends: the ``approx_join`` driver and the
``JoinServer``, each on the plain route and on the kernel route (the
kernels' plain versions on the CPU), over 30 seeded replications against
the port's exact ``repartition_join``; then the gate's own self-tests, which
must reject a biased, an overconfident and a lossy backend.  The single-device
cases of ``tests/test_accuracy_gate.py`` (its mesh cases wait for the
distributed port); the last test holds the port's gate workloads and ground
truth to the JAX harness's (integer counts exactly, sums within rtol 1e-5).
"""

import pytest

import accuracy
import torch_accuracy
from torch_accuracy import (GateConfig, one_torch_thread,  # noqa: F401
                            run_accuracy_gate)
from repro_torch.core.budget import QueryBudget
from repro_torch.core.join import approx_join
from repro_torch.runtime.join_serve import JoinRequest, JoinServer

CFG = GateConfig()


def _approx_join_backend(use_kernels=False):
    def backend(rels, seed):
        res = approx_join(
            rels, QueryBudget(error=0.5, pilot_fraction=CFG.pilot_fraction),
            max_strata=CFG.max_strata, b_max=CFG.b_max, seed=seed,
            use_kernels=use_kernels)
        return (float(res.estimate), float(res.error_bound),
                float(res.count), res.stats)
    return backend


approx_join_backend = _approx_join_backend()


def make_server_backend(server: JoinServer, use_kernels: bool = False):
    """One registered dataset + one pilot-round query per replication."""
    def backend(rels, seed):
        name = f"rep{seed}"
        server.register_dataset(name, rels)
        q = server.submit(JoinRequest(
            dataset=name,
            budget=QueryBudget(error=0.5, pilot_fraction=CFG.pilot_fraction),
            query_id=name, seed=seed, max_strata=CFG.max_strata,
            b_max=CFG.b_max, use_kernels=use_kernels))
        server.run()
        return (float(q.result.estimate), float(q.result.error_bound),
                float(q.result.count), q.result.stats)
    return backend


def test_accuracy_gate_approx_join():
    rep = run_accuracy_gate(approx_join_backend, CFG)
    assert rep.passed, rep.summary()
    assert rep.checked_allocation


def test_accuracy_gate_server():
    srv = JoinServer(batch_slots=1)
    rep = run_accuracy_gate(make_server_backend(srv), CFG)
    assert rep.passed, rep.summary()
    assert rep.checked_allocation
    assert srv.diagnostics.dist_dropped_tuples == 0.0


def test_accuracy_gate_approx_join_kernels():
    """Kernel-route row: the kernel operator (its plain versions on the
    CPU) passes the same statistical contract as the plain driver."""
    rep = run_accuracy_gate(_approx_join_backend(use_kernels=True), CFG)
    assert rep.passed, rep.summary()
    assert rep.checked_allocation


def test_accuracy_gate_server_kernels():
    """Kernel-route row, served: the batched kernel engine passes the gate
    and moves no rows to the host."""
    srv = JoinServer(batch_slots=1)
    rep = run_accuracy_gate(make_server_backend(srv, use_kernels=True), CFG)
    assert rep.passed, rep.summary()
    assert rep.checked_allocation
    assert srv.diagnostics.kernel_queries == CFG.replications
    assert srv.diagnostics.kernel_gather_bytes == 0.0


def test_gate_rejects_biased_backend():
    """Harness self-test: a backend whose estimate is 20% off must fail."""
    def biased(rels, seed):
        est, bound, cnt, _ = approx_join_backend(rels, seed)
        return est * 1.2, bound, cnt, None
    rep = run_accuracy_gate(biased, GateConfig(replications=10))
    assert not rep.passed, rep.summary()


def test_gate_rejects_overconfident_backend():
    """A backend reporting absurdly tight error bounds must fail coverage."""
    def overconfident(rels, seed):
        est, bound, cnt, _ = approx_join_backend(rels, seed)
        return est, bound * 1e-4, cnt, None
    rep = run_accuracy_gate(overconfident, GateConfig(replications=10))
    assert not rep.passed, rep.summary()


def test_gate_rejects_silent_drops():
    """Uncounted lost tuples surface as a count mismatch."""
    def lossy(rels, seed):
        est, bound, cnt, _ = approx_join_backend(rels, seed)
        return est, bound, cnt * 0.9, None
    rep = run_accuracy_gate(lossy, GateConfig(replications=5))
    assert not rep.passed, rep.summary()


@pytest.mark.parametrize("r", [0, 7])
def test_gate_workload_and_truth_match_jax_harness(r):
    """The port's replication r is the JAX harness's: the same relations
    (keys exactly, values exactly) and the same ground truth (count
    exactly, SUM within rtol 1e-5: float32 sums in another order)."""
    rels_t, (sum_t, cnt_t) = torch_accuracy._workload(
        torch_accuracy.GateConfig(), r)
    rels_j, (sum_j, cnt_j) = accuracy._workload(accuracy.GateConfig(), r)
    for a, b in zip(rels_j, rels_t):
        assert (b.keys.numpy() == a.keys.__array__().astype("int64")).all()
        assert (b.values.numpy() == a.values.__array__()).all()
        assert (b.valid.numpy() == a.valid.__array__()).all()
    assert cnt_t == cnt_j
    assert sum_t == pytest.approx(sum_j, rel=1e-5)
