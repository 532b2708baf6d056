"""Serving runtime: the batched multi-tenant ``JoinServer`` with query
plans and snapshot/restore (``join_serve.py``), the windowed
``StreamJoinServer`` built on it (``stream_join.py``), the always-on async
tier and its crash-safe fleet (``async_serve.py``), atomic checkpoints
(``checkpoint.py``), fault handling (``fault.py``), the telemetry they
report through (``telemetry.py``) and the train step (``train.py``)."""

from repro_torch.runtime.async_serve import AsyncJoinFrontDoor, AsyncJoinServer
from repro_torch.runtime.checkpoint import (CheckpointCorruptError,
                                            latest_step, load_checkpoint,
                                            restore_checkpoint,
                                            save_checkpoint)
from repro_torch.runtime.fault import (InjectedFault, elastic_restore,
                                       elastic_restore_engine, guarded_step)
from repro_torch.runtime.join_serve import JoinRequest, JoinServer, PlanHandle
from repro_torch.runtime.stream_join import StreamJoinServer

__all__ = ["AsyncJoinFrontDoor", "AsyncJoinServer", "CheckpointCorruptError",
           "latest_step", "load_checkpoint", "restore_checkpoint",
           "save_checkpoint", "InjectedFault", "elastic_restore",
           "elastic_restore_engine", "guarded_step", "JoinRequest",
           "JoinServer", "PlanHandle", "StreamJoinServer"]
