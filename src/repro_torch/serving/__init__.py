"""Serving: the single-stream ``Server`` and the continuous-batching
``ServeEngine`` fleet (``engine``) over the device-resident page pool
(``kv_pool``) and its scheduler (``scheduler``); ``migrate`` moves live
sessions between engines of different MPI flavors over the interposed p2p
plane, digest-verified like the elastic join path."""
from repro_torch.serving.engine import ServeEngine, Server
from repro_torch.serving.kv_pool import PagePool, PoolOOMError
from repro_torch.serving.migrate import (MigrationError, MigrationLink,
                                         MigrationReport, migrate_sessions)
from repro_torch.serving.scheduler import ContinuousBatchScheduler

__all__ = ["ServeEngine", "Server", "PagePool", "PoolOOMError",
           "ContinuousBatchScheduler", "MigrationError", "MigrationLink",
           "MigrationReport", "migrate_sessions"]
