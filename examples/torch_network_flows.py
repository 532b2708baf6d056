"""Paper §6.1 on the PyTorch port: 'What is the total size of the flows that
appeared in all TCP, UDP and ICMP traffic?' — a 3-way join over CAIDA-like
flow tables, exact vs budgeted-approximate, with the shuffle-volume meters,
as ``examples/network_flows.py`` computes it, on the card.

Run:  PYTHONPATH=src python examples/torch_network_flows.py [--device cpu]
"""

import argparse
import time

from repro_torch.core.baselines import native_join
from repro_torch.core.budget import QueryBudget
from repro_torch.core.cost import sync
from repro_torch.core.join import approx_join
from repro_torch.data.flows import flow_tables
from repro_torch.launch.mesh import check_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="3-way flow join")
    ap.add_argument("--device", default="cuda",
                    help="the CUDA card (default) or 'cpu'")
    args = ap.parse_args(argv)
    where = check_device(args.device, "torch_network_flows")
    dev = args.device
    print(f"on {where}")

    tcp, udp, icmp = flow_tables(scale=8192, shared_fraction=0.03, seed=7,
                                 device=dev)
    rels = [icmp, udp, tcp]   # lead with the smallest input (fewest strata)
    print(f"flows: tcp={int(tcp.count())} udp={int(udp.count())} "
          f"icmp={int(icmp.count())}")

    t0 = time.perf_counter()
    exact = approx_join(rels, QueryBudget(), max_strata=8192)
    sync(dev)
    t_exact = time.perf_counter() - t0
    d = exact.diagnostics
    print(f"exact:   total bytes = {float(exact.estimate)!r}  "
          f"({int(exact.count)} joined flow triples, {t_exact:.2f}s)")
    ratio = float(d.shuffled_bytes_repartition) \
        / float(d.shuffled_bytes_filtered)
    print(f"         shuffle reduction: {ratio:.1f}x less data on the wire "
          f"than a repartition join")

    t0 = time.perf_counter()
    approx = approx_join(rels, QueryBudget(error=0.02, pilot_fraction=0.1),
                         max_strata=8192, b_max=256, seed=1)
    sync(dev)
    t_approx = time.perf_counter() - t0
    err = abs(float(approx.estimate) - float(exact.estimate)) \
        / float(exact.estimate)
    print(f"sampled: total bytes = {float(approx.estimate):.4g} "
          f"+/- {float(approx.error_bound):.3g}  "
          f"({t_approx:.2f}s, true rel err {err:.4f})")

    base = native_join(rels)
    if abs(float(base.estimate) - float(exact.estimate)) \
            > 1e-5 * abs(float(exact.estimate)) \
            or int(base.count) != int(exact.count):
        raise SystemExit("native join disagrees with the filtered exact path")
    print("native 3-way join agrees with the filtered exact path  [OK]")


if __name__ == "__main__":
    main()
