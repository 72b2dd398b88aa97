"""Service layer of the port (reference: ``repro/service``): shape buckets,
work items and packing (``bucketing``), the packed-batch runner
(``scheduler.BucketRunner``) and the structural-hash result cache
(``cache.ResultCache``, which ``Session.verify`` reads).  The request server
and the slot scheduler belong to the service route, which is not ported yet
(ROADMAP Queue 1, item 6)."""
from repro_torch.service.bucketing import BucketShape, WorkItem, pack_batch  # noqa: F401
from repro_torch.service.cache import CacheStats, ResultCache  # noqa: F401
from repro_torch.service.scheduler import BucketRunner  # noqa: F401

__all__ = ["BucketShape", "WorkItem", "pack_batch", "BucketRunner", "CacheStats", "ResultCache"]
