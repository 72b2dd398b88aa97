"""Retry/backoff policy shared with the service (port of the first part of
``repro/distributed/fault_tolerance.py``).

:func:`retry_call` replays a failed call ``retries`` times with exponential
backoff and seeded jitter (:func:`backoff_delays`), and only for failures
:func:`is_transient` accepts.  The service runs each lone item's device
attempt through it.  A CUDA error is sticky — the context is unusable
after it — so it is not transient: it fails the ticket at once.

The reference's ``ResilientLoop`` (step checkpoints, straggler detection)
needs the step checkpoints of ``checkpoint/manager.py``, which the port
does not have yet (ROADMAP Queue 1, item 8).
"""
from __future__ import annotations

import random
import time
from typing import Any, Callable, Iterator, Optional


def backoff_delays(
    retries: int,
    *,
    base_s: float = 0.05,
    factor: float = 2.0,
    jitter: float = 0.5,
    max_s: float = 5.0,
    seed: object = 0,
) -> Iterator[float]:
    """``retries`` exponential backoff delays with deterministic jitter.

    Delay *i* is ``min(max_s, base_s * factor**i) * (1 + jitter * u_i)``
    with ``u_i`` drawn from a ``random.Random`` seeded from ``seed``
    (string-seeded, so the same (seed, attempt) always jitters the same —
    chaos runs replay bit-identically).
    """
    rng = random.Random(f"backoff:{seed}")
    for attempt in range(max(0, retries)):
        yield min(max_s, base_s * factor ** attempt) * (1.0 + jitter * rng.random())


def is_transient(exc: BaseException) -> bool:
    """Is this failure plausibly cleared by a retry?

    An injected :class:`repro_torch.faults.TransientFault` (and anything
    whose class name says Transient), connection and timeout errors, and
    the reference's retryable status codes in the message qualify.  An
    injected ``FatalFault`` — and any ordinary logic error or CUDA error —
    does not: retrying a poisoned design only burns device time.
    """
    from repro_torch import faults

    if isinstance(exc, faults.FatalFault):
        return False
    if isinstance(exc, (faults.TransientFault, ConnectionError, TimeoutError)):
        return True
    if "Transient" in type(exc).__name__:
        return True
    msg = str(exc)
    return any(code in msg for code in ("UNAVAILABLE", "ABORTED", "DEADLINE_EXCEEDED"))


def retry_call(
    fn: Callable[[], Any],
    *,
    retries: int,
    seed: object = 0,
    base_s: float = 0.05,
    should_retry: Callable[[BaseException], bool] = is_transient,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
):
    """Call ``fn`` with up to ``retries`` backoff-spaced replays.

    Only failures ``should_retry`` accepts are replayed; ``on_retry``
    (attempt index, exception) runs before each sleep — the service uses it
    to bump its retry counter and re-check ticket deadlines (raising from
    ``on_retry`` aborts the retry loop with that error).
    """
    delays = backoff_delays(retries, base_s=base_s, seed=seed)
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — classified below
            delay = next(delays, None)
            if delay is None or not should_retry(e):
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(delay)
            attempt += 1
