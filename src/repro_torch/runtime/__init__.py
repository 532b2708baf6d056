"""Serving runtime: the batched multi-tenant ``JoinServer``
(``join_serve.py``), the windowed ``StreamJoinServer`` built on it
(``stream_join.py``) and the telemetry they report through
(``telemetry.py``).

Importing this package imports none of them, so it stays light.
"""
