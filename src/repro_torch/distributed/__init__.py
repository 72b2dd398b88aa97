"""Distribution and failure handling (port of ``repro/distributed``): the
retry/backoff policy and the restartable training loop
(``fault_tolerance``), elastic re-meshing (``elastic``), int8
error-feedback gradient all-reduce (``grad_compression``) and the GPipe
schedule (``pipeline_parallel``)."""
