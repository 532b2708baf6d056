"""Serving runtime: the batched multi-tenant ``JoinServer``
(``join_serve.py``) and the telemetry it reports through
(``telemetry.py``).

Importing this package imports neither module, so it stays light.
"""
