"""Service layer of the port (reference: ``repro/service``); only
``bucketing.BucketShape`` so far."""
