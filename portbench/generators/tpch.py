"""TPC-H's ORDERS and CUSTOMER, projected to the money query's columns.

ORDERS (o_custkey, o_totalprice) and CUSTOMER (c_custkey, c_acctbal):
customer keys 1..``customer_rows``, a random ``customers_with_orders`` of them
holding every order, each order's customer uniform among those, c_acctbal
uniform in [-999.99, 9999.99] and o_totalprice uniform in [800, 500000].
ORDERS comes first: its keys lead the strata.
"""

from __future__ import annotations

import torch

from portbench.generators import generator


def generate(cfg: dict, seed: int, device) -> list:
    g = generator(seed, device)
    n_cust, n_ord = cfg["customer_rows"], cfg["orders_rows"]
    cust = torch.arange(1, n_cust + 1, device=device)
    acctbal = torch.rand(n_cust, generator=g, device=device) \
        * (9999.99 + 999.99) - 999.99
    holders = cust[torch.randperm(n_cust, generator=g, device=device)[
        :cfg["customers_with_orders"]]]
    o_cust = holders[torch.randint(holders.shape[0], (n_ord,), generator=g,
                                   device=device)]
    price = torch.rand(n_ord, generator=g, device=device) \
        * (500_000.0 - 800.0) + 800.0
    return [(o_cust, price), (cust, acctbal)]
