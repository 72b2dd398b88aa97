"""Failure handling shared across layers (reference: ``repro/distributed``):
the retry/backoff policy and the restartable training loop of
``fault_tolerance``."""
