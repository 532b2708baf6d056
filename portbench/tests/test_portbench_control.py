"""The check that decides ``correct`` fails the control (the reference in
bfloat16 put in the program's place) and every fault a cell can have, planted
under a run that skips the harness's look for a card; a sound run passes.
On the CPU at the sizes of ``conftest.TINY``."""

from __future__ import annotations

import pytest
import torch

from portbench import control, harness, verify

SEED = 2**31 + 991
CELLS = ("s51-dash-error", "tpch-sf30-exact")


def _run(root, cell, seconds=1.0):
    return harness.run_cell(root, cell, SEED, seconds, False, device="cpu",
                            log=lambda *a: None)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny_root, cell):
    r = _run(tiny_root, cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 16
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(tiny_root, cell):
    limits = harness.load_cell(tiny_root, cell).limits
    for seed in (SEED, SEED + 1, SEED + 2):
        values = control.control_numbers(tiny_root, cell, seed, 48,
                                         device="cpu")
        assert not verify.judge(values, limits)[0], values
        gap = "est_gap" if "est_gap" in values else "exact_gap"
        assert values[gap] > limits[gap]


def _altered(monkeypatch, js):
    """An answer altered where it is produced: every estimate 1e-3 high."""
    sample, exact = js.sample_stage_kernels_batched, js.exact_stage

    def bad_sample(*a, **k):
        value, err, cnt, dof, stats = sample(*a, **k)
        return value * (1 + 1e-3), err, cnt, dof, stats

    def bad_exact(*a, **k):
        est, cnt = exact(*a, **k)
        return est * (1 + 1e-3), cnt
    monkeypatch.setattr(js, "sample_stage_kernels_batched", bad_sample)
    monkeypatch.setattr(js, "exact_stage", bad_exact)


def _half(monkeypatch, js):
    """Half of the batch's rows left out, the sum taken as twice the rest."""
    from repro_torch.core.relation import Relation
    prepare = js.prepare_stage_kernels_batched

    def bad(rels, *a, **k):
        keep = torch.arange(rels[0].keys.shape[-1]) % 2 == 0
        cut = [Relation(r.keys, r.values * 2,
                        r.valid & keep[:r.keys.shape[-1]]) for r in rels]
        return prepare(cut, *a, **k)
    monkeypatch.setattr(js, "prepare_stage_kernels_batched", bad)


def _stale(monkeypatch, js):
    """A step that returns its state unchanged: every step after the first
    hands back the first step's answer."""
    run = js.JoinServer._run_batch
    first = []

    def bad(self, cls, batch):
        if first:
            for r in batch:
                r.result = first[0]
            return
        run(self, cls, batch)
        first.append(batch[0].result)
    monkeypatch.setattr(js.JoinServer, "_run_batch", bad)


def _forget_sigma(monkeypatch, js):
    """A SigmaRegistry that keeps nothing: every request draws the pilot
    fraction, as on a query's first execution."""
    from repro_torch.core.cost import SigmaRegistry
    monkeypatch.setattr(SigmaRegistry, "update", lambda self, *a: None)


def _first_sigma(monkeypatch, js):
    """A SigmaRegistry that keeps each stratum's first sigma: every request
    is sized by the pilot's sigmas, not by its last execution's."""
    from repro_torch.core.cost import SigmaRegistry
    update = SigmaRegistry.update

    def bad(self, query_id, *a):
        if query_id not in self.table:
            update(self, query_id, *a)
    monkeypatch.setattr(SigmaRegistry, "update", bad)


FAULTS = [(cell, f) for cell in CELLS for f in (_altered, _half, _stale)] \
    + [("s51-dash-error", f) for f in (_forget_sigma, _first_sigma)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_fault_under_the_timed_path_fails(tiny_root, monkeypatch, cell,
                                            fault):
    from repro_torch.runtime import join_serve as js
    fault(monkeypatch, js)
    r = _run(tiny_root, cell)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cells_on_the_card(tiny_root, cell):
    """A traced run at the tiny size on the card is correct and reads the
    device; the control fails there too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = harness.run_cell(tiny_root, cell, SEED, 2.0, True, device="cuda",
                         log=lambda *a: None)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert "device_idle_pct" in r["metrics"]
    assert "bloom_probe_roofline" in r["metrics"]
    values = control.control_numbers(tiny_root, cell, SEED, 48,
                                     device="cuda")
    assert not verify.judge(values, harness.load_cell(tiny_root, cell)
                            .limits)[0], values
