"""Quickstart of the PyTorch port: the paper's query surface, as
``examples/quickstart.py`` computes it, on the card.

    SELECT SUM(R1.V + R2.V) FROM R1, R2 WHERE R1.A = R2.A
    ERROR 0.01 CONFIDENCE 95%

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core.baselines import native_join
from repro_torch.core.budget import parse_budget
from repro_torch.core.join import approx_join
from repro_torch.core.relation import relation
from repro_torch.launch.mesh import check_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="ApproxJoin quickstart")
    ap.add_argument("--device", default="cuda",
                    help="the CUDA card (default) or 'cpu'")
    args = ap.parse_args(argv)
    where = check_device(args.device, "torch_quickstart")
    dev = args.device
    print(f"on {where}")

    rng = np.random.default_rng(0)
    N = 1 << 14
    # Two inputs with partially overlapping keys (only the shared keys join).
    r1 = relation(rng.integers(0, 1000, N).astype(np.uint32),
                  rng.normal(10.0, 2.0, N).astype(np.float32), device=dev)
    r2 = relation(rng.integers(800, 1800, N).astype(np.uint32),
                  rng.normal(5.0, 1.0, N).astype(np.float32), device=dev)

    # --- exact join (no budget): Bloom-filtered, sufficient statistics ---
    exact = approx_join([r1, r2])
    d = exact.diagnostics
    print(f"exact    SUM = {float(exact.estimate)!r}   "
          f"join size = {int(exact.count)}")
    print(f"         overlap fraction = {float(d.overlap_fraction):.3f}, "
          f"shuffle {int(d.shuffled_bytes_filtered)} B vs "
          f"{int(d.shuffled_bytes_repartition)} B unfiltered")

    # --- approximate join under the paper's budget clause ---
    budget = parse_budget("ERROR 0.01 CONFIDENCE 95%")
    approx = approx_join([r1, r2], budget, max_strata=2048, b_max=1024,
                         seed=1)
    err = abs(float(approx.estimate) - float(exact.estimate)) \
        / float(exact.estimate)
    print(f"sampled  SUM = {float(approx.estimate):14.1f} "
          f"+/- {float(approx.error_bound):10.1f}   "
          f"(draws = {int(approx.diagnostics.sample_draws)}, "
          f"true rel err = {err:.5f})")

    # --- sanity: the unfiltered baseline agrees ---
    base = native_join([r1, r2])
    if abs(float(base.estimate) - float(exact.estimate)) \
            > 1e-5 * abs(float(exact.estimate)):
        raise SystemExit("native join disagrees with the filtered exact path")
    print("native join agrees with the filtered exact path  [OK]")


if __name__ == "__main__":
    main()
