"""TPC-H-lite generator (paper §5.5).

The paper strips TPC-H Q3/Q4/Q10 down to their join cores and also runs the
"money before ordering" query SUM(o_totalprice + c_acctbal) over
CUSTOMER |><| ORDERS.  We generate schema-faithful scaled tables:

  CUSTOMER  (c_custkey,  c_acctbal)     — 150 K rows / SF
  ORDERS    (o_orderkey, o_custkey, o_totalprice) — 1.5 M rows / SF
  LINEITEM  (l_orderkey, l_extendedprice)         — ~6 M rows / SF

Value distributions follow TPC-H's uniform specs (acctbal in [-999.99,
9999.99], totalprice compound).  The tables are numpy arrays (the same draws
as the JAX implementation's generator); each query core returns the
Relations keyed on the join attribute on ``device``, ready for approx_join /
the baselines.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core.relation import Relation, relation


class TPCH(NamedTuple):
    customer_key: np.ndarray      # c_custkey
    customer_acctbal: np.ndarray
    orders_key: np.ndarray        # o_orderkey
    orders_custkey: np.ndarray
    orders_totalprice: np.ndarray
    lineitem_orderkey: np.ndarray
    lineitem_extprice: np.ndarray


def generate(scale: float = 0.01, seed: int = 0) -> TPCH:
    """Scaled TPC-H tables (scale=1.0 ~ the 1 GB spec; default 0.01)."""
    rng = np.random.default_rng(seed)
    n_cust = max(int(150_000 * scale), 16)
    n_ord = n_cust * 10
    n_li = int(n_ord * 4)  # avg ~4 lineitems per order

    cust_key = np.arange(1, n_cust + 1, dtype=np.uint32)
    acctbal = rng.uniform(-999.99, 9999.99, n_cust).astype(np.float32)

    ord_key = np.arange(1, n_ord + 1, dtype=np.uint32)
    # TPC-H: only 2/3 of customers have orders
    custs_with_orders = rng.choice(cust_key, size=max(2 * n_cust // 3, 1),
                                   replace=False)
    ord_cust = rng.choice(custs_with_orders, size=n_ord).astype(np.uint32)
    totalprice = rng.uniform(800.0, 500_000.0, n_ord).astype(np.float32)

    li_ord = rng.choice(ord_key, size=n_li).astype(np.uint32)
    extprice = rng.uniform(900.0, 100_000.0, n_li).astype(np.float32)
    return TPCH(cust_key, acctbal, ord_key, ord_cust, totalprice,
                li_ord, extprice)


def q_customer_orders(t: TPCH, device="cuda") -> list[Relation]:
    """§5.5 query: SUM(o_totalprice + c_acctbal) over CUSTOMER |><| ORDERS."""
    return [relation(t.orders_custkey, t.orders_totalprice, device=device),
            relation(t.customer_key, t.customer_acctbal, device=device)]


def q3_core(t: TPCH, device="cuda") -> list[list[Relation]]:
    """Q3 join core: customer |><| orders (custkey), orders |><| lineitem
    (orderkey) — two joins, returned as two relation pairs."""
    return [q_customer_orders(t, device), q4_core(t, device)]


def q4_core(t: TPCH, device="cuda") -> list[Relation]:
    """Q4 join core: orders |><| lineitem on orderkey (one join)."""
    return [relation(t.orders_key, t.orders_totalprice, device=device),
            relation(t.lineitem_orderkey, t.lineitem_extprice, device=device)]


def q10_core(t: TPCH, device="cuda") -> list[list[Relation]]:
    """Q10 join core: customer |><| orders |><| lineitem (two joins)."""
    return q3_core(t, device)
