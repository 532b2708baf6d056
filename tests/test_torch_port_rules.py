"""Rules of the PyTorch port that no parity test would catch.

* ``repro_torch`` (its model stack too), ``chip_smoke.py`` and the port's
  examples import neither JAX nor ``repro``;
* the card is the default device: without CUDA, building a relation or a
  ``Model`` with the default device raises instead of landing on the CPU,
  and so do the examples (unless ``--device cpu`` asks for the CPU), the
  serving launcher (sync, ``--async``, ``--mesh`` and both together), the
  streaming launcher (with and without ``--mesh``) and the train launcher
  (with and without ``--dp``, with ``--tp``, an ssm arch's too) unless
  ``--device cpu`` asks for the CPU, where an ssm arch trains at ``--tp 2``
  and writes a checkpoint the JAX package restores;
* no mesh server refuses what a meshless one serves;
* a CPU tensor takes a kernel's plain version and launches nothing;
* ``chip_smoke.py`` fails, printing no result, without a card or without the
  rest of the repository;
* a program that ran mesh ranks leaves no helper process when it ends;
* torch's ``fake`` process-group backend is named in ``launch/mesh.py``
  alone (``fake_ranks``, which only the dry runs call), and the join dry
  run, on the card by default, fails without one.
"""

import json
import os
import pkgutil
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.relation import relation
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                       re.MULTILINE)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_port_modules_import_no_jax_and_no_reference():
    mods = _port_modules()
    for m in ("repro_torch.core.join", "repro_torch.kernels.ops",
              "repro_torch.runtime.join_serve", "repro_torch.runtime.telemetry",
              "repro_torch.launch.join_serve", "repro_torch.launch.trace_dump",
              "repro_torch.core.window", "repro_torch.core.baselines",
              "repro_torch.core.sampling", "repro_torch.data.tpch",
              "repro_torch.data.flows", "repro_torch.data.netflix",
              "repro_torch.runtime.stream_join",
              "repro_torch.launch.join_stream", "repro_torch.core.plan",
              "repro_torch.runtime.checkpoint", "repro_torch.runtime.fault",
              "repro_torch.runtime.async_serve",
              "repro_torch.core.distributed", "repro_torch.launch.mesh",
              "repro_torch.models.config", "repro_torch.models.layers",
              "repro_torch.models.trunk", "repro_torch.models.model",
              "repro_torch.models.moe", "repro_torch.models.ssm",
              "repro_torch.models.rglru", "repro_torch.models.encdec",
              "repro_torch.models.convert", "repro_torch.configs",
              "repro_torch.configs.shapes",
              "repro_torch.configs.qwen3_1_7b", "repro_torch.optim.adamw",
              "repro_torch.optim.compress", "repro_torch.data.pipeline",
              "repro_torch.runtime.train", "repro_torch.sharding",
              "repro_torch.sharding.specs", "repro_torch.sharding.axes",
              "repro_torch.launch.train", "repro_torch.launch.roofline",
              "repro_torch.launch.dryrun", "repro_torch.launch.dryrun_join",
              "repro_torch.launch.report", "repro_torch.kernels.traffic"):
        assert m in mods, m
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_port_sources_name_no_jax_and_no_reference():
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert [f.name for f in examples] == [
        "torch_network_flows.py", "torch_quickstart.py",
        "torch_tpch_budget.py", "torch_train_lm.py"]
    # and the rank functions the port's mesh tests spawn
    ranks = [ROOT / "tests" / f for f in ("torch_dist.py",
                                          "torch_train_ranks.py")]
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + examples \
        + ranks
    assert len(files) > 10
    bad = [f"{f}: {m.group(0).strip()}" for f in files
           for m in FORBIDDEN.finditer(f.read_text())]
    assert bad == []


FAKE = re.compile(r"""["']fake["']|fake_pg|FakeStore""")


def test_fake_backend_only_in_the_mesh_module():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted(
        (ROOT / "examples").glob("torch_*.py"))
    named = sorted(str(f.relative_to(ROOT)) for f in files
                   if FAKE.search(f.read_text()))
    assert named == ["src/repro_torch/launch/mesh.py"]
    callers = sorted(str(f.relative_to(ROOT)) for f in files
                     if "fake_ranks(" in f.read_text())
    assert callers == ["src/repro_torch/launch/dryrun.py",
                       "src/repro_torch/launch/dryrun_join.py",
                       "src/repro_torch/launch/mesh.py"]


def test_dry_runs_on_the_card_fail_without_one():
    for module, args in (("repro_torch.launch.dryrun_join",
                          ("--log2-rows", "12")),
                         ("repro_torch.launch.dryrun",
                          ("--device", "cuda", "--arch", "qwen3-1.7b",
                           "--shape", "decode_32k"))):
        out = _launch_without_a_card(module, *args)
        assert out.returncode != 0
        assert "no CUDA card" in out.stderr
        assert "==" not in out.stdout


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert relation([1, 2, 3]).keys.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            relation([1, 2, 3])


def test_model_defaults_to_the_card_and_never_falls_back():
    """``Model(cfg)`` and ``params_from_jax`` build on the card unless asked
    for the CPU; without a card they raise."""
    import inspect

    from repro_torch.models import ARCHS, Model
    from repro_torch.models.convert import params_from_jax
    assert inspect.signature(Model).parameters["device"].default == "cuda"
    assert inspect.signature(params_from_jax).parameters[
        "device"].default == "cuda"
    cfg = ARCHS["qwen3-1.7b"].reduced()
    if torch.cuda.is_available():
        assert Model(cfg).embed.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            Model(cfg)
    assert not Model(cfg, device="cpu").embed.is_cuda


@pytest.mark.parametrize("example", ["torch_quickstart.py",
                                     "torch_network_flows.py",
                                     "torch_tpch_budget.py",
                                     "torch_train_lm.py"])
def test_example_without_a_card_fails_and_joins_nothing(example):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / example)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**env, "PYTHONPATH": str(ROOT / "src"),
             "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "no CUDA card" in out.stderr
    assert "exact" not in out.stdout
    assert "[mixture]" not in out.stdout and "[train" not in out.stdout


def _launch_without_a_card(module, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-m", module, *args],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**env, "PYTHONPATH": str(ROOT / "src"),
             "CUDA_VISIBLE_DEVICES": ""})


def test_launcher_without_a_card_fails_and_serves_nothing():
    """Run without ``--device cpu`` and hidden from every card, the serving
    launcher raises instead of falling back to the CPU."""
    out = _launch_without_a_card(
        "repro_torch.launch.join_serve", "--tenants", "1",
        "--queries-per-tenant", "1", "--base-n", "256")
    assert out.returncode != 0
    assert "no CUDA card" in out.stderr
    assert "[join-serve]" not in out.stdout


def test_async_launcher_without_a_card_fails_and_serves_nothing(tmp_path):
    """The same for the serving launcher's async fleet and its drill: no
    replica starts serving on the CPU."""
    out = _launch_without_a_card(
        "repro_torch.launch.join_serve", "--async", "--replicas", "2",
        "--checkpoint-dir", str(tmp_path / "ckpt"), "--kill-after", "1",
        "--tenants", "1", "--queries-per-tenant", "1", "--base-n", "256")
    assert out.returncode != 0
    assert "no CUDA card" in out.stderr
    assert "[join-serve" not in out.stdout
    assert not (tmp_path / "ckpt").exists()


def test_mesh_launcher_without_a_card_fails_and_serves_nothing():
    """``--mesh 2`` hidden from every card raises before it starts a rank;
    given ``--device cpu --dist-backend gloo`` it serves on two CPU ranks,
    and NCCL on the CPU is refused, not swapped for gloo."""
    small = ("--tenants", "1", "--queries-per-tenant", "1", "--base-n", "256")
    out = _launch_without_a_card("repro_torch.launch.join_serve", "--mesh",
                                 "2", *small)
    assert out.returncode != 0
    assert "no CUDA card" in out.stderr
    assert "[join-serve" not in out.stdout
    out = _launch_without_a_card("repro_torch.launch.join_serve", "--mesh",
                                 "2", "--device", "cpu", "--dist-backend",
                                 "nccl", *small)
    assert out.returncode != 0
    assert "nccl backend needs tensors on a CUDA card" in out.stderr
    assert "[join-serve" not in out.stdout
    out = _launch_without_a_card("repro_torch.launch.join_serve", "--mesh",
                                 "2", "--device", "cpu", "--dist-backend",
                                 "gloo", *small)
    assert out.returncode == 0, out.stderr
    assert "on mesh[2] gloo on cpu" in out.stdout
    assert "dist_shuffled_tuple_bytes=" in out.stdout


def test_async_mesh_launcher_without_a_card_fails_and_serves_nothing(
        tmp_path):
    """``--async --mesh 2`` hidden from every card raises before it starts
    a rank or a replica; given ``--device cpu --dist-backend gloo`` its
    fleet of mesh servers serves on two CPU ranks, and its drill fails
    replica0 over once, every query served once."""
    small = ("--async", "--mesh", "2", "--tenants", "2",
             "--queries-per-tenant", "2", "--base-n", "256")
    out = _launch_without_a_card("repro_torch.launch.join_serve", *small)
    assert out.returncode != 0
    assert "no CUDA card" in out.stderr
    assert "[join-serve" not in out.stdout
    out = _launch_without_a_card(
        "repro_torch.launch.join_serve", *small, "--device", "cpu",
        "--dist-backend", "gloo", "--checkpoint-dir", str(tmp_path / "ck"),
        "--kill-after", "1")
    assert out.returncode == 0, out.stderr
    assert "on mesh[2] gloo on cpu x2 replicas" in out.stdout
    # replica0 dies at its first step and fails over onto the mesh; no
    # query is lost or served twice
    m = re.search(r"failovers=(\d+) futures_failed=(\d+) .*live fleet "
                  r"queries=(\d+) = (\d+) returned \+ (\d+) failed",
                  out.stdout)
    assert m, out.stdout
    failovers, failed, fleet, returned, failed2 = map(int, m.groups())
    assert failovers == 1 and failed == failed2
    assert fleet == returned + failed and returned + failed == 4


def test_stream_mesh_launcher_without_a_card_fails_and_streams_nothing():
    """``join_stream --mesh 2`` hidden from every card raises before it
    starts a rank; on two gloo CPU ranks it streams to the end."""
    small = ("--mesh", "2", "--tenants", "1", "--pushes", "5",
             "--sub-rows", "256")
    out = _launch_without_a_card("repro_torch.launch.join_stream", *small)
    assert out.returncode != 0
    assert "no CUDA card" in out.stderr
    assert "[join-stream]" not in out.stdout
    out = _launch_without_a_card("repro_torch.launch.join_stream", *small,
                                 "--device", "cpu", "--dist-backend", "gloo",
                                 "--serve-mode", "psum")
    assert out.returncode == 0, out.stderr
    assert "on mesh[2] gloo on cpu (psum)" in out.stdout
    assert "dist_shuffled_tuple_bytes=" in out.stdout


def test_mesh_servers_refuse_nothing_the_meshless_ones_serve():
    """No mesh refusal is left in the port: plans, prebuilt window words,
    snapshots and restores are served on a mesh too."""
    pat = re.compile(r"_check_meshless|not ported yet|ROADMAP A5b")
    bad = [f"{f}:{i + 1}" for f in sorted(PORT.rglob("*.py"))
           for i, line in enumerate(f.read_text().splitlines())
           if pat.search(line)]
    assert bad == []


def test_train_launcher_without_a_card_fails_and_trains_nothing(tmp_path):
    """The train launcher hidden from every card raises before it builds a
    model, with ``--dp 2`` or ``--tp 2`` before it starts a rank, an ssm
    arch's ``--tp 2`` too; on the CPU that arch trains at ``--tp 2`` and
    its checkpoint loads into the JAX package's train state."""
    small = ("--arch", "qwen2-0.5b", "--reduced", "--steps", "2",
             "--ckpt-dir", str(tmp_path / "ck"))
    ssm = ("--arch", "falcon-mamba-7b", "--tp", "2")
    for extra in ((), ("--dp", "2"), ("--tp", "2"), ssm):
        out = _launch_without_a_card("repro_torch.launch.train", *small,
                                     *extra)
        assert out.returncode != 0
        assert "no CUDA card" in out.stderr
        assert "[train]" not in out.stdout
    assert not (tmp_path / "ck").exists()
    out = _launch_without_a_card("repro_torch.launch.train", *small,
                                 "--device", "cpu", *ssm)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[train] done on cpu, dp 1 x tp 2" in out.stdout
    import jax

    from repro.models import ARCHS as JARCHS
    from repro.models import Model as JModel
    from repro.runtime.checkpoint import restore_checkpoint
    from repro.runtime.train import train_state_init
    cfg = JARCHS["falcon-mamba-7b"].reduced(vocab=512, d_model=128,
                                            d_ff=256, n_layers=2)
    like = train_state_init(JModel(cfg), jax.random.key(0))
    got, _ = restore_checkpoint(str(tmp_path / "ck"), 2, like)
    assert jax.tree.structure(got) == jax.tree.structure(like)
    assert int(got.opt.step) == 2


def test_stream_launcher_without_a_card_fails_and_streams_nothing():
    """The same for the streaming launcher."""
    out = _launch_without_a_card(
        "repro_torch.launch.join_stream", "--tenants", "1", "--pushes", "2",
        "--sub-rows", "256")
    assert out.returncode != 0
    assert "no CUDA card" in out.stderr
    assert "[join-stream]" not in out.stdout


def test_cpu_tensors_take_the_plain_versions():
    from repro_torch.kernels import bloom_build, bloom_probe, edge_sample, ops
    counters = (bloom_build.bloom_build_batched, bloom_probe.bloom_probe_batched,
                edge_sample.edge_sample_batched)
    before = [c.launches for c in counters]
    r = relation(np.arange(100, dtype=np.uint32), device="cpu")
    f = ops.build_filter(r.keys, r.valid, 64, seed=2**40 + 3)
    assert ops.probe_filter(f.words, r.keys, seed=2**40 + 3).all()
    assert [c.launches for c in counters] == before


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**env, "CUDA_VISIBLE_DEVICES": ""})


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_repo(alone, tmp_path):
    """Hidden from every card (and, alone, from the package too), the smoke
    run exits non-zero and prints no result line."""
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path if alone else ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_ranks_leave_no_process_behind_their_program(tmp_path):
    """A program that ran ranks leaves no helper process when it ends: the
    fork server and resource tracker are stopped at exit and waited for,
    and :func:`stop_rank_server` stops them at once, after which a new
    spawn starts a new server."""
    import textwrap

    prog = textwrap.dedent("""
        import os, sys
        from multiprocessing import forkserver, resource_tracker
        from repro_torch.launch.mesh import stop_rank_server
        from torch_dist import spawn
        from tests_helpers import one_rank
        spawn(one_rank, 1, (), sys.argv[1])
        helpers = [forkserver._forkserver._forkserver_pid,
                   resource_tracker._resource_tracker._pid]
        stop_rank_server()
        for pid in helpers:
            try:
                os.kill(pid, 0)
                sys.exit(f"helper {pid} still runs after stop_rank_server")
            except ProcessLookupError:
                pass
        assert spawn(one_rank, 1, (), sys.argv[1]) == [1]
        print(forkserver._forkserver._forkserver_pid,
              resource_tracker._resource_tracker._pid)
    """)
    (tmp_path / "tests_helpers.py").write_text(
        "def one_rank(mesh, dev):\n    return 1\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), str(tmp_path)]))
    out = subprocess.run([sys.executable, "-c", prog, str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr
    for pid in map(int, out.stdout.split()):
        # the second server and tracker were stopped at the program's exit
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
