"""Sort-as-a-service: the persistent serving layer (port of
``mpitest_tpu/serve/``).

A long-lived process pays setup once, bounds its queue, packs small
requests into one dispatch, and answers each request with typed errors:

* :mod:`~mpitest_tpu_torch.serve.executor_cache` — one warm packed-sort
  callable per (shape bucket, dtype, word count), power-of-two bucketing,
  and the startup build of the kernels, so warm requests never pay a
  first call;
* :mod:`~mpitest_tpu_torch.serve.admission` — bounds in-flight requests
  and payload bytes with typed backpressure;
* :mod:`~mpitest_tpu_torch.serve.batching` — packs concurrent small
  requests into one segmented dispatch within a bounded window;
* :mod:`~mpitest_tpu_torch.serve.server` — the ``sortserve.v1`` TCP
  protocol, per-request supervision, ``serve.*`` spans, the spill tier
  and the graceful drain;
* :mod:`~mpitest_tpu_torch.serve.watchdog`,
  :mod:`~mpitest_tpu_torch.serve.sentinel`,
  :mod:`~mpitest_tpu_torch.serve.telemetry` — the dispatch watchdog and
  circuit breaker, the streaming SLO sentinel, the HTTP side port;
* :mod:`~mpitest_tpu_torch.serve.client` — the matching client.

Entry point: ``python -m mpitest_tpu_torch.sort_server``.
"""

__all__ = [
    "AdmissionControl", "AdmissionReject", "ExecutorCache", "ServerCore",
    "SortServer", "bucket_for",
]

#: Lazy exports (PEP 562): ``serve.client`` stays importable without the
#: server stack (torch, the models layer).
_EXPORTS = {
    "AdmissionControl": "mpitest_tpu_torch.serve.admission",
    "AdmissionReject": "mpitest_tpu_torch.serve.admission",
    "ExecutorCache": "mpitest_tpu_torch.serve.executor_cache",
    "bucket_for": "mpitest_tpu_torch.serve.executor_cache",
    "ServerCore": "mpitest_tpu_torch.serve.server",
    "SortServer": "mpitest_tpu_torch.serve.server",
}


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
