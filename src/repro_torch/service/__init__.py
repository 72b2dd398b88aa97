"""Verification-as-a-service: the request layer over the GROOT flow (port of
``repro/service``).

    repro_torch.io.aiger  ->  VerificationService.submit()/poll()
                                |-- ResultCache (structural-hash dedup)
                                |-- prepare pool (host: partition + re-growth)
                                |-- ShapeBucketScheduler (device: padded buckets)
                                `-- verify (host: adders + simulation check)

``python -m repro_torch.cli serve`` runs the CLI front end.
"""
from repro_torch.service.cache import CacheStats, ResultCache  # noqa: F401
from repro_torch.service.bucketing import BucketShape, WorkItem, pack_batch  # noqa: F401
from repro_torch.service.scheduler import (  # noqa: F401
    BucketRunner,
    ShapeBucketScheduler,
    SlotPool,
)

_SERVER_EXPORTS = ("AdmissionError", "DeadlineExceeded", "ServiceConfig", "ServiceResult",
                   "VerificationService")
__all__ = [
    "CacheStats", "ResultCache", "BucketShape", "WorkItem", "pack_batch",
    "BucketRunner", "ShapeBucketScheduler", "SlotPool", *_SERVER_EXPORTS,
]


def __getattr__(name):
    # lazy, so `python -m repro_torch.service.server` does not import it twice
    if name in _SERVER_EXPORTS:
        from repro_torch.service import server

        return getattr(server, name)
    raise AttributeError(name)
