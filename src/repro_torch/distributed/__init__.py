"""Failure handling shared across layers (reference: ``repro/distributed``):
the retry/backoff policy of ``fault_tolerance``."""
