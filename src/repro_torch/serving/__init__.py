"""Serving: the single-stream ``Server`` and the continuous-batching
``ServeEngine`` fleet (``engine``) over the device-resident page pool
(``kv_pool``) and its scheduler (``scheduler``)."""
from repro_torch.serving.engine import ServeEngine, Server
from repro_torch.serving.kv_pool import PagePool, PoolOOMError
from repro_torch.serving.scheduler import ContinuousBatchScheduler

__all__ = ["ServeEngine", "Server", "PagePool", "PoolOOMError",
           "ContinuousBatchScheduler"]
