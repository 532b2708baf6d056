"""Command-line drivers: ``python -m repro_torch.launch.join_serve`` serves
a multi-tenant query stream (``--async`` through the replica fleet, with
``--checkpoint-dir`` and ``--kill-after`` for the fault drill),
``python -m repro_torch.launch.join_stream`` serves windows over micro-batch
streams, ``python -m repro_torch.launch.trace_dump`` reads the trace a
serving run writes, and ``python -m repro_torch.launch.train`` trains a
model (``--dp`` ranks, checkpoints, elastic restore)."""
