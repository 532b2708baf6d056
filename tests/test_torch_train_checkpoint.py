"""Train checkpoints across the two packages and through the port's
launcher.

A train state written by the JAX package's ``save_checkpoint`` after two
steps is restored by the port, and the port's by the JAX package's
``restore_checkpoint``: params, AdamW moments and step bit for bit both
ways (the reference's layout: stacks stacked, ``params_to_jax``'s names).
Six steps straight equal three + save/restore + three bit for bit on the
CPU (``tests/test_runtime.py::test_checkpoint_bit_exact_resume``), and the
launcher killed after its step-6 checkpoint resumes there to the
uninterrupted run's final checkpoint, bit for bit.
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from repro.data.pipeline import lm_batch as jlm_batch
from repro.models import ARCHS as JARCHS
from repro.models import Model as JModel
from repro.runtime import checkpoint as JCK
from repro.runtime.train import make_train_step as jmake_step
from repro.runtime.train import train_state_init as jstate_init
from repro_torch.data.pipeline import lm_batch
from repro_torch.models import ARCHS
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import checkpoint as TCK
from repro_torch.runtime.train import (load_train_state, make_train_step,
                                       train_state_init, train_state_tree)
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2-0.5b"


def _setup():
    """(JAX step, JAX state, port model, port step) from the same weights."""
    cfg = JARCHS[ARCH].reduced(vocab=128)
    jm = JModel(cfg)
    jstate = jstate_init(jm, jax.random.key(0))
    tm = params_from_jax(ARCHS[ARCH].reduced(vocab=128),
                         jax.tree.map(np.asarray, jstate.params),
                         device="cpu")
    return (jax.jit(jmake_step(jm, total_steps=6, warmup=2)), jstate, tm,
            make_train_step(tm, total_steps=6, warmup=2))


def _batch(i, torch_side):
    if torch_side:
        return lm_batch(i, 0, batch=4, seq=32, vocab=128, structured=True,
                        device="cpu")
    return jlm_batch(i, 0, batch=4, seq=32, vocab=128, structured=True)


def _same(want: dict, got: dict) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        w, g = np.asarray(w), np.asarray(got[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _host(tree) -> dict:
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in TCK._flatten(tree).items()}


def test_jax_train_checkpoint_restored_by_the_port(tmp_path):
    jstep, jstate, tm, _ = _setup()
    for i in range(2):
        jstate, _ = jstep(jstate, _batch(i, False))
    JCK.save_checkpoint(str(tmp_path), 2, jstate)
    like = train_state_tree(train_state_init(tm))
    tree, _ = TCK.restore_checkpoint(str(tmp_path), 2, like, device="cpu")
    state = load_train_state(tree, tm)
    assert state.opt.step.dtype == torch.int32 and int(state.opt.step) == 2
    assert state.params["embed"] is tm.embed
    _same({k: np.asarray(v) for k, v in JCK._flatten(jstate).items()},
          _host(train_state_tree(state)))


def test_port_train_checkpoint_restored_by_jax(tmp_path):
    _, jstate, tm, tstep = _setup()
    state = train_state_init(tm)
    for i in range(2):
        state, _ = tstep(state, _batch(i, True))
    TCK.save_checkpoint(str(tmp_path), 2, train_state_tree(state))
    restored, _ = JCK.restore_checkpoint(str(tmp_path), 2, jstate)
    assert jax.tree.structure(restored) == jax.tree.structure(jstate)
    _same(_host(train_state_tree(state)),
          {k: np.asarray(v) for k, v in JCK._flatten(restored).items()})


def test_checkpoint_bit_exact_resume(tmp_path):
    """6 steps straight against 3 + save/restore into a fresh model + 3:
    the same parameters, moments and step, bit for bit."""
    _, _, tm, tstep = _setup()
    straight = train_state_init(tm)
    for i in range(6):
        straight, _ = tstep(straight, _batch(i, True))
    _, _, tm2, tstep2 = _setup()
    state = train_state_init(tm2)
    for i in range(3):
        state, _ = tstep2(state, _batch(i, True))
    TCK.save_checkpoint(str(tmp_path), 3, train_state_tree(state))
    _, _, tm3, tstep3 = _setup()
    like = train_state_tree(train_state_init(tm3))
    tree, _ = TCK.restore_checkpoint(str(tmp_path), 3, like, device="cpu")
    resumed = load_train_state(tree, tm3)
    for i in range(3, 6):
        resumed, _ = tstep3(resumed, _batch(i, True))
    _same(_host(train_state_tree(straight)),
          _host(train_state_tree(resumed)))


def _launch(ckpt_dir, *extra):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "2"}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", ARCH, "--reduced", "--steps", "12", "--ckpt-every", "6",
         "--batch", "4", "--seq", "32", "--ckpt-dir", str(ckpt_dir), *extra],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)


def test_launcher_killed_after_a_checkpoint_resumes_there(tmp_path):
    """``--kill-after 6`` dies (SIGKILL) once its step-6 checkpoint is on
    disk; the rerun resumes from step 6 and ends at the uninterrupted
    run's final checkpoint, bit for bit."""
    out = _launch(tmp_path / "straight")
    assert out.returncode == 0, out.stderr
    out = _launch(tmp_path / "killed", "--kill-after", "6")
    assert out.returncode == -signal.SIGKILL, (out.returncode, out.stderr)
    assert TCK.latest_step(str(tmp_path / "killed")) == 6
    out = _launch(tmp_path / "killed")
    assert out.returncode == 0, out.stderr
    assert "[train] resumed from step 6" in out.stdout
    assert "step     0 loss" not in out.stdout
    want, _ = TCK.load_checkpoint(str(tmp_path / "straight"), 12)
    got, _ = TCK.load_checkpoint(str(tmp_path / "killed"), 12)
    _same(want, got)
