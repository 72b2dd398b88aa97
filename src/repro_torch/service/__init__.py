"""Service layer of the port (reference: ``repro/service``): shape buckets,
work items and packing (``bucketing``) and the packed-batch runner
(``scheduler.BucketRunner``).  The request server, the result cache and the
slot scheduler belong to the service route, which is not ported yet
(ROADMAP Queue 1, item 6)."""
from repro_torch.service.bucketing import BucketShape, WorkItem, pack_batch  # noqa: F401
from repro_torch.service.scheduler import BucketRunner  # noqa: F401

__all__ = ["BucketShape", "WorkItem", "pack_batch", "BucketRunner"]
