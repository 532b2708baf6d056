"""The ApproxJoin operator: hashing, relations, Bloom filters, sampling,
estimators, budgets and the join itself (see ``core/join.py``)."""
