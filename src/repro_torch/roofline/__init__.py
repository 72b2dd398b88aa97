"""The dry run's cost model (port of ``repro/roofline``): the per-device
counter of a traced step (``counter``) and the roofline report (``report``)."""
