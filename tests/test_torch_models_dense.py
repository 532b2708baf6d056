"""The attention archs at ``reduced()``: the port against the JAX package
with the same weights (``params_from_jax``) and inputs, forward logits,
loss and a step-by-step decode from an empty cache, in float32 and in bf16
(tolerances in ``tests/torch_models_parity.py``).  And ``qwen3-1.7b`` at
its full depth of 28 layers in bf16: each package's decode within the
reference's 0.08 of its own forward."""

import pytest

from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)
from torch_models_parity import no_grad  # noqa: F401  (autouse)
from torch_models_parity import batch, check_arch, models, rel, run_both

DENSE = ["qwen3-1.7b", "qwen2-0.5b", "granite-20b", "gemma2-9b",
         "phi-3-vision-4.2b"]


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_arch_matches_jax(arch, dtype, monkeypatch):
    check_arch(arch, dtype, monkeypatch)


def test_bf16_decode_within_the_bound_of_forward_at_28_layers(capsys):
    jm, p, tm = models("qwen3-1.7b", n_layers=28)
    (jl, _, jd), (tl, _, td) = run_both(jm, p, tm, batch(jm.cfg, T=16), 16)
    jax_err, port_err = rel(jl, jd)[0], rel(tl, td)[0]
    with capsys.disabled():
        print(f"\nqwen3-1.7b reduced, 28 layers, bf16: decode against "
              f"forward, largest over the scale: JAX {jax_err!r}, port "
              f"{port_err!r}")
    assert jax_err <= 0.08 and port_err <= 0.08, (jax_err, port_err)
