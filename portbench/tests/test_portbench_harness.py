"""The benchmark's manifest, files, generators and metric arithmetic, on the
CPU at the sizes of ``conftest.TINY``."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch
from conftest import ROOT, TINY

from portbench import harness, yardstick
from portbench.generators import generate

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
BENCH = ROOT / MANIFEST["paths"][0]
SEED = 2**31 + 2**30 + 77


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    names = [x["name"] for x in MANIFEST["configs"] + MANIFEST["workloads"]
             + metrics]
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in MANIFEST["end_to_end"]}
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    assert all(f"`{layer}`" in perf for layer in layers)


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_entry_resolves_to_its_files(cell):
    c = harness.load_cell(ROOT, cell)
    # one card, or four where at most a quarter of the cells (one always)
    # take four, and their client pattern stops its processes and reads
    # their cards' peaks
    assert c.chips in (1, 4)
    workloads = MANIFEST["workloads"]
    assert sum(w["chips"] == 4 for w in workloads) <= \
        max(1, len(workloads) // 4)
    assert c.config["name"] == next(w["config"] for w in MANIFEST["workloads"]
                                    if w["name"] == cell)
    assert {"kind", "source", "clients", "queries", "query_of",
            "warm_rounds"} <= set(c.traffic)
    assert c.traffic["query_of"] in ("client", "request")
    pattern = harness.client_pattern(c)
    assert callable(pattern.Clients) and callable(pattern.planned)
    if c.chips == 4:
        assert callable(getattr(pattern.Clients, "close", None))
        assert callable(getattr(pattern.Clients, "peaks", None))
    assert {"unanswered", "live_diff", "overflow", "path_diff",
            "strata_diff"} <= set(c.limits)
    reported = {m["name"] for m in c.end_to_end + c.per_layer}
    for name in reported:
        assert callable(harness.reader(c.bench, name))
    # every cell reports setup_s, another end-to-end metric and a per-layer
    assert "setup_s" in {m["name"] for m in c.end_to_end}
    assert len(c.end_to_end) >= 2 and c.per_layer


def test_every_metric_has_its_reader_and_every_reader_a_metric():
    files = {p.stem for p in (BENCH / "metrics").glob("*.py")}
    assert files == {m["name"] for m in MANIFEST["end_to_end"]
                     + MANIFEST["per_layer"]}


@pytest.mark.parametrize("config", sorted(TINY))
def test_generators_repeat_under_the_seed(tiny_root, config):
    cfg = json.loads((tiny_root / "portbench" / "configs"
                      / f"{config}.json").read_text())
    a, b = (generate(cfg, SEED, "cpu") for _ in range(2))
    c = generate(cfg, SEED + 1, "cpu")
    for (ka, va), (kb, vb) in zip(a, b):
        assert torch.equal(ka, kb) and torch.equal(va, vb)
    assert any(not torch.equal(ka, kc) for (ka, _), (kc, _) in zip(a, c))
    for keys, values in a:
        assert keys.dtype == torch.int64 and values.dtype == torch.float32
        assert int(keys.min()) >= 0 and int(keys.max()) < 0xFFFFFFFF


def test_s51_sizes_and_overlap(tiny_root):
    cfg = json.loads((tiny_root / "portbench/configs/s51-2e26.json")
                     .read_text())
    rels = generate(cfg, SEED, "cpu")
    assert [k.shape[0] for k, _ in rels] == cfg["rows"]
    sets = [set(k.tolist()) for k, _ in rels]
    for (keys, values), other in zip(rels, reversed(sets)):
        assert len(set(keys.tolist())) <= cfg["keys_per_dataset"]
        # only the shared pool's rows join; every shared key is drawn here
        joining = sum(int(k) in other for k in keys.tolist())
        assert joining == round(keys.shape[0] * cfg["overlap_fraction"])
        assert abs(float(values.mean()) - cfg["poisson_lambda"]) < 0.5


def test_tpch_sizes_and_keys(tiny_root):
    cfg = json.loads((tiny_root / "portbench/configs/tpch-sf30.json")
                     .read_text())
    (o_key, price), (c_key, bal) = generate(cfg, SEED, "cpu")
    assert o_key.shape[0] == cfg["orders_rows"]
    assert torch.equal(c_key, torch.arange(1, cfg["customer_rows"] + 1))
    holders = set(o_key.tolist())
    assert holders <= set(c_key.tolist())
    assert len(holders) <= cfg["customers_with_orders"]
    assert float(price.min()) >= 800 and float(price.max()) <= 500_000
    assert float(bal.min()) >= -999.99 and float(bal.max()) <= 9999.99


def test_a_cell_added_from_files_alone_runs(tmp_path):
    """A new configuration (of two datasets), mix and cell are new files and
    manifest entries: no file of the harness changes."""
    from conftest import tiny_tree
    root = tiny_tree(tmp_path)
    bench = root / "portbench"
    cfg = json.loads((bench / "configs/s51-2e26.json").read_text())
    cfg.update(name="s51-extra", overlap_fraction=0.25,
               rows=[2048, 4096], datasets=2)
    (bench / "configs/s51-extra.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic/dash-error.json").read_text())
    mix.update(clients=4, verify_span=4, verify_sample=2, query_of="request",
               queries=[{"agg": "sum", "expr": "sum",
                         "budget": {"error": 0.25}},
                        {"agg": "sum", "expr": "sum",
                         "budget": {"error": 1.0}}])
    (bench / "traffic/dash-few.json").write_text(json.dumps(mix))
    shutil.copy(bench / "workloads/s51-dash-error.json",
                bench / "workloads/s51-extra-few.json")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "s51-extra", "source": "test",
                                "file": "portbench/configs/s51-extra.json",
                                "reduced": [], "why": "test"})
    manifest["workloads"].append({"name": "s51-extra-few",
                                  "config": "s51-extra",
                                  "traffic": "dash-few", "chips": 1,
                                  "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    r = harness.run_cell(root, "s51-extra-few", SEED, 1.0, False,
                         device="cpu", log=lambda *a: None)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 4 and r["failed"] == 0
    assert {"queries_per_s", "e2e_p95_ms", "setup_s"} <= set(r["metrics"])
    # two datasets of the configuration's sizes, the second from its own seed
    cell = harness.load_cell(root, "s51-extra-few")
    a, b = (harness.dataset_inputs(cell, SEED, i, "cpu") for i in (0, 1))
    assert cell.datasets == 2 and not torch.equal(a[0][0], b[0][0])
    assert [k.shape[0] for k, _ in b] == cfg["rows"]


def test_a_client_pattern_is_found_by_the_mix_kind(tmp_path):
    """A mix names its client pattern, ``traffic/<kind>.py``: a new pattern
    is a new file, and a kind with no file is refused."""
    from conftest import tiny_tree
    root = tiny_tree(tmp_path)
    bench = root / "portbench"
    # a pattern of one client at a time, on the closed loop's code
    (bench / "traffic/one_client.py").write_text(
        "import importlib.util, pathlib\n"
        "_p = pathlib.Path(__file__).with_name('closed_loop.py')\n"
        "_s = importlib.util.spec_from_file_location('one_client_base', _p)\n"
        "_m = importlib.util.module_from_spec(_s)\n"
        "_s.loader.exec_module(_m)\n"
        "filter_seed, planned, verify_indices = "
        "_m.filter_seed, _m.planned, _m.verify_indices\n"
        "class Clients(_m.Clients):\n"
        "    def __init__(self, ctx):\n"
        "        super().__init__(ctx)\n"
        "        self.clients = 1\n")
    mix = json.loads((bench / "traffic/exact-mixed.json").read_text())
    mix.update(kind="one_client", warm_widths=[1])
    (bench / "traffic/exact-one.json").write_text(json.dumps(mix))
    shutil.copy(bench / "workloads/tpch-sf30-exact.json",
                bench / "workloads/tpch-one.json")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": "tpch-one", "config": "tpch-sf30",
                                  "traffic": "exact-one", "chips": 1,
                                  "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    r = harness.run_cell(root, "tpch-one", SEED, 1.0, False, device="cpu",
                         log=lambda *a: None)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 2 and r["failed"] == 0
    mix["kind"] = "no_such_pattern"
    (bench / "traffic/exact-one.json").write_text(json.dumps(mix))
    with pytest.raises(ValueError, match="no_such_pattern"):
        harness.run_cell(root, "tpch-one", SEED, 1.0, False, device="cpu",
                         log=lambda *a: None)


def test_a_configuration_without_a_cut_is_refused(tmp_path, monkeypatch):
    import conftest
    monkeypatch.setattr(conftest, "TINY", {
        k: v for k, v in conftest.TINY.items() if k != "tpch-sf30"})
    with pytest.raises(FileNotFoundError,
                       match=re.escape(str(conftest.CUTS / "tpch-sf30.json"))):
        conftest.tiny_tree(tmp_path)


# a pattern over four cards, on the closed loop's code: its processes' peak
# above the harness's own, a log of its close, and a raise where the mix
# says
FOUR_PEAK = 3 * 2**30 + 12345
FOUR_CARDS = """\
import importlib.util, pathlib
_p = pathlib.Path(__file__).with_name('closed_loop.py')
_s = importlib.util.spec_from_file_location('four_cards_base', _p)
_m = importlib.util.module_from_spec(_s)
_s.loader.exec_module(_m)
filter_seed, planned, verify_indices = \\
    _m.filter_seed, _m.planned, _m.verify_indices
LOG = pathlib.Path(__file__).with_name('calls.log')


class Clients(_m.Clients):
    def _maybe_raise(self, where):
        if self.cell.traffic.get('raise_in') == where:
            raise RuntimeError(f'{where} failed')

    def warm(self):
        self._maybe_raise('warm')
        super().warm()

    def window(self, seconds, profile):
        self._maybe_raise('window')
        return super().window(seconds, profile)

    def drain(self):
        self._maybe_raise('drain')
        super().drain()

    def peaks(self):
        return [PEAK, 2**20]

    def close(self):
        with LOG.open('a') as f:
            f.write('close\\n')


PEAK = %d
""" % FOUR_PEAK


def _four_card_tree(tmp_path, raise_in=None):
    """A cell over four cards added from files alone: a client pattern with
    ``peaks`` and ``close``, a mix, a limits file and a manifest entry."""
    from conftest import tiny_tree
    root = tiny_tree(tmp_path)
    bench = root / "portbench"
    (bench / "traffic/four_cards.py").write_text(FOUR_CARDS)
    mix = json.loads((bench / "traffic/exact-mixed.json").read_text())
    mix.update(kind="four_cards", raise_in=raise_in)
    (bench / "traffic/exact-four.json").write_text(json.dumps(mix))
    shutil.copy(bench / "workloads/tpch-sf30-exact.json",
                bench / "workloads/tpch-four.json")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": "tpch-four", "config": "tpch-sf30",
                                  "traffic": "exact-four", "chips": 4,
                                  "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


@pytest.mark.parametrize("raise_in", [None, "warm", "window", "drain"])
def test_a_four_card_cell_added_from_files_alone(tmp_path, monkeypatch,
                                                 raise_in):
    """The run reports the fullest card's peak, the pattern's, and calls
    its ``close`` once: before the reference, or after a failed stage."""
    root = _four_card_tree(tmp_path, raise_in)
    log = root / "portbench/traffic/calls.log"
    prepare = harness.ref_join.prepare

    def logged(*a, **k):
        with log.open("a") as f:
            f.write("prepare\n")
        return prepare(*a, **k)
    monkeypatch.setattr(harness.ref_join, "prepare", logged)

    def run():
        return harness.run_cell(root, "tpch-four", SEED, 1.0, False,
                                device="cpu", log=lambda *a: None)
    if raise_in is not None:
        with pytest.raises(RuntimeError, match=f"{raise_in} failed"):
            run()
        assert log.read_text().split() == ["close"]
        return
    r = run()
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 2 and r["failed"] == 0
    assert r["device"]["count"] == 4
    assert r["device"]["memory_peak_bytes"] == FOUR_PEAK
    assert r["metrics"]["peak_mem_gib"]["value"] == FOUR_PEAK / 2**30
    cell = harness.load_cell(root, "tpch-four")
    assert log.read_text().split() == ["close"] + ["prepare"] * cell.datasets


@pytest.mark.parametrize("found", [0, 1])
def test_the_command_refuses_a_four_card_cell_on_fewer_cards(tmp_path,
                                                             found):
    """With fewer cards than the cell asks for (none on the CPU) the command
    exits with code 2 and prints no result."""
    root = _four_card_tree(tmp_path)
    code = ("import runpy, sys, torch; "
            + (f"torch.cuda.is_available = lambda: True; "
               f"torch.cuda.device_count = lambda: {found}; " if found
               else "")
            + "sys.argv = ['run.py', '--workload', 'tpch-four', "
            "'--seed', '3000000001', '--seconds', '1', '--trace', '0']; "
            "runpy.run_path('portbench/run.py', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2, out.stderr
    assert out.stdout.strip() == ""
    assert f"needs 4 CUDA card(s), found {found}" in out.stderr


def _rec(**kw):
    base = dict(setup_s=1.0, window_s=2.0, requests=[], steps=[],
                peak_bytes=0, events=[], device=None)
    base.update(kw)
    return harness.Records(**base)


def test_p95_is_over_every_request():
    e2e = [0.001 * i for i in range(1, 101)]
    rec = _rec(requests=[{"e2e_s": x, "queue_s": x / 2} for x in e2e])
    read = harness.reader(BENCH, "e2e_p95_ms")
    assert read(rec) == pytest.approx(95.05)
    assert harness.reader(BENCH, "queue_p95_ms")(rec) == pytest.approx(47.525)
    assert harness.reader(BENCH, "queries_per_s")(rec) == pytest.approx(50.0)
    assert read(_rec()) is None


def test_idle_share_takes_the_union_of_device_intervals():
    # two overlapping ops and one apart: busy 0.3 + 0.1 of a 1.0 s window
    ops = [("a", 0.1, 0.3), ("b", 0.2, 0.4), ("c", 0.6, 0.7)]
    rec = _rec(device={"lo": 0.0, "hi": 1.0, "ops": ops, "steps": []})
    assert harness.reader(BENCH, "device_idle_pct")(rec) == pytest.approx(60)
    assert yardstick.idle_gaps([(a, b) for _, a, b in ops], 0.0, 1.0) == [
        (0.0, 0.1), (0.4, 0.6), (0.7, 1.0)]


def test_rooflines_count_each_launch_bytes_once():
    step = {"width": 8, "caps": [1 << 20, 1 << 18], "num_blocks": 1 << 16,
            "max_strata": 1 << 10, "gathered": 4096.0}
    probe = [(8, 1 << 20, 1 << 16), (8, 1 << 18, 1 << 16)]
    nbytes = sum(8 * n * 8 + 8 * nb * 32 + 8 * 8 + 8 * n
                 for _, n, nb in probe)
    secs = nbytes / yardstick.HBM_BYTES_PER_S / 0.5     # at half the rate
    ops = [("(anonymous namespace)::bloom_probe_kernel(unsigned int const*)",
            0.0, secs / 2),
           ("(anonymous namespace)::bloom_probe_kernel(unsigned int const*)",
            1.0, 1.0 + secs / 2),
           ("void at::native::other_kernel<float>()", 0.0, 5.0)]
    rec = _rec(device={"lo": 0, "hi": 9, "ops": ops, "steps": [step]})
    assert harness.reader(BENCH, "bloom_probe_roofline")(rec) == \
        pytest.approx(50.0)
    # a launch the trace lacks: nothing to read
    rec = _rec(device={"lo": 0, "hi": 9, "ops": ops[1:], "steps": [step]})
    assert harness.reader(BENCH, "bloom_probe_roofline")(rec) is None
    es = 8 * 1024 * (8 + 32 + 1 + 4) + 8 * 8 + 4096 + 8 * 1024 * 12
    assert yardstick.edge_sample_bytes(8, 1024, 4096.0) == es
    secs = es / yardstick.HBM_BYTES_PER_S
    ops = [("(anonymous namespace)::plan_kernel(int)", 0.0, secs / 4),
           ("(anonymous namespace)::sample_kernel(int)", 1.0,
            1.0 + 3 * secs / 4)]
    rec = _rec(device={"lo": 0, "hi": 9, "ops": ops, "steps": [step]})
    assert harness.reader(BENCH, "edge_sample_roofline")(rec) == \
        pytest.approx(100.0)
    assert yardstick.edge_sample_gathered(
        [[3.0, 5.0, 2.0]], [[[2, 9, 1]], [[4, 4, 0]]], [[True, True, False]]
    ) == (2 + 5 + 3 + 4) * 4


def test_host_time_is_the_step_less_its_stages():
    ev = [{"tid": "engine", "name": "step", "ts": 0.0, "dur": 1.0},
          {"tid": "engine", "name": "prepare", "ts": 0.1, "dur": 0.5},
          {"tid": "engine", "name": "sample", "ts": 0.7, "dur": 0.1},
          {"tid": "q:x#1", "name": "prepare", "ts": 0.1, "dur": 0.5},
          {"tid": "engine", "name": "step", "ts": 2.0, "dur": 0.5},
          {"tid": "engine", "name": "exact", "ts": 2.1, "dur": 0.2}]
    rec = _rec(events=ev)
    assert harness.reader(BENCH, "host_ms_per_step")(rec) == \
        pytest.approx(1e3 * (0.4 + 0.3) / 2)
    assert harness.reader(BENCH, "prepare_ms_per_step")(rec) == \
        pytest.approx(250.0)
    assert harness.reader(BENCH, "sample_ms_per_step")(rec) == \
        pytest.approx(50.0)
    steps = [{"served": 8}, {"served": 6}, {"served": 0}]
    assert harness.reader(BENCH, "slots_per_step")(_rec(steps=steps)) == 7.0
