"""Paper §5.5 on the PyTorch port: TPC-H CUSTOMER |><| ORDERS — 'how much
money did customers have before ordering?' — under a LATENCY budget, with
the cost function picking the sample size and the sigma feedback loop
tightening the second run (§3.2), as ``examples/tpch_budget.py`` computes
it, on the card.

Run:  PYTHONPATH=src python examples/torch_tpch_budget.py [--device cpu]
"""

import argparse
import time

from repro_torch.core.baselines import native_join
from repro_torch.core.budget import QueryBudget
from repro_torch.core.cost import SigmaRegistry, calibrate_beta, sync
from repro_torch.core.join import approx_join
from repro_torch.data import tpch
from repro_torch.launch.mesh import check_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="TPC-H join under a budget")
    ap.add_argument("--device", default="cuda",
                    help="the CUDA card (default) or 'cpu'")
    args = ap.parse_args(argv)
    where = check_device(args.device, "torch_tpch_budget")
    dev = args.device
    print(f"on {where}")

    t = tpch.generate(scale=0.01, seed=3)
    rels = tpch.q_customer_orders(t, device=dev)
    print(f"CUSTOMER rows = {len(t.customer_key)}, "
          f"ORDERS rows = {len(t.orders_key)}")

    print("calibrating beta_compute (paper Fig. 5 offline profiling)...")
    cost = calibrate_beta(device=dev)
    print(f"  beta = {cost.beta_compute:.3e} s/edge, "
          f"eps = {cost.epsilon:.3e} s")

    exact = approx_join(rels, QueryBudget(), max_strata=1 << 14)
    print(f"exact SUM(o_totalprice + c_acctbal) = {float(exact.estimate)!r}"
          f"   join size = {int(exact.count)}")

    for budget_s in (0.1, 0.3):
        t0 = time.perf_counter()
        res = approx_join(rels, QueryBudget(latency_s=budget_s),
                          cost_model=cost, max_strata=1 << 14, b_max=2048,
                          seed=4)
        sync(dev)
        took = time.perf_counter() - t0
        err = abs(float(res.estimate) - float(exact.estimate)) \
            / float(exact.estimate)
        mode = "sampled" if res.diagnostics.sampled else "exact-fastpath"
        print(f"WITHIN {budget_s:.2f} SECONDS -> {took:.3f}s ({mode}), "
              f"estimate {float(res.estimate):.6g}, rel err {err:.5f}")

    # error budget with the feedback loop: run 1 pilots, run 2 uses sigma
    reg = SigmaRegistry()
    for attempt in (1, 2):
        res = approx_join(rels, QueryBudget(error=50.0), max_strata=1 << 14,
                          b_max=2048, sigma_registry=reg, query_id="money",
                          seed=4 + attempt)
        print(f"ERROR 50 run {attempt}: estimate {float(res.estimate):.6g} "
              f"+/- {float(res.error_bound):.4g} "
              f"(draws {int(res.diagnostics.sample_draws)})")

    base = native_join(rels)
    if abs(float(base.estimate) - float(exact.estimate)) \
            > 1e-5 * abs(float(exact.estimate)):
        raise SystemExit("native join disagrees with the filtered exact path")
    print("native join agrees with the filtered exact path  [OK]")


if __name__ == "__main__":
    main()
