"""The ApproxJoin operator: hashing, relations, Bloom filters (with the
Appendix-B variants), sampling, estimators, budgets, the join itself (see
``core/join.py``) and query plans of n-way joins (``core/plan.py``)."""

from repro_torch.core.plan import (CompiledNode, CompiledPlan, Plan, PlanNode,
                                   compile_plan, node_bytes_model)

__all__ = ["CompiledNode", "CompiledPlan", "Plan", "PlanNode", "compile_plan",
           "node_bytes_model"]
