"""Fault tolerance (port of ``repro/distributed/fault_tolerance.py``): the
retry/backoff policy shared with the service, heartbeat/straggler
monitoring and the restartable step loop.

:func:`retry_call` replays a failed call ``retries`` times with exponential
backoff and seeded jitter (:func:`backoff_delays`), and only for failures
:func:`is_transient` accepts.  The service runs each lone item's device
attempt through it.  A CUDA error is sticky — the context is unusable
after it — so it is not transient: it fails the ticket at once.

:class:`ResilientLoop` wraps a training step function with per-step wall
time tracking (an EWMA straggler detector: a step over
``straggler_factor`` x the EWMA is recorded as a :class:`StragglerEvent`),
a :class:`Heartbeat` file, periodic async checkpoints with
restore-on-construction (a relaunched job resumes after the last published
step) and bounded retry of failed steps, every failure treated as a
preemption.  It copies the reference's retry quirk (ROADMAP Queue 3 item
11): a retried step restores the newest published checkpoint but keeps
``step`` and the current batch, so the steps between that checkpoint and
the failure are dropped, not replayed.  ``ResilientLoop`` takes a
``device`` where the reference takes ``shardings``.
"""
from __future__ import annotations

import dataclasses
import json
import random
import time
from pathlib import Path
from typing import Any, Callable, Iterator, Optional

from repro_torch.checkpoint.manager import CheckpointManager, latest_step, restore


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


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    ewma: float


class Heartbeat:
    """Liveness file the launcher can poll (one per host)."""

    def __init__(self, directory: str, host_id: int = 0):
        self.path = Path(directory) / f"heartbeat_{host_id}.json"
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def beat(self, step: int):
        self.path.write_text(json.dumps({"step": step, "t": time.time()}))

    @staticmethod
    def stale_hosts(directory: str, timeout_s: float) -> list:
        now = time.time()
        out = []
        for p in Path(directory).glob("heartbeat_*.json"):
            data = json.loads(p.read_text())
            if now - data["t"] > timeout_s:
                out.append(p.stem)
        return out


class ResilientLoop:
    def __init__(
        self,
        step_fn: Callable,                   # (state, batch) -> (state, metrics)
        init_state: Any,
        *,
        ckpt_dir: str,
        ckpt_every: int = 50,
        straggler_factor: float = 3.0,
        max_retries: int = 2,
        device=None,
        host_id: int = 0,
    ):
        self.step_fn = step_fn
        self.ckpt = CheckpointManager(ckpt_dir)
        self.ckpt_every = ckpt_every
        self.straggler_factor = straggler_factor
        self.max_retries = max_retries
        self.heartbeat = Heartbeat(ckpt_dir, host_id)
        self.stragglers: list = []
        self.ewma: Optional[float] = None
        self.device = device

        if latest_step(ckpt_dir) is not None:
            self.state, self.step = restore(init_state, ckpt_dir, device=device)
            self.step += 1
            self.resumed = True
        else:
            self.state, self.step = init_state, 0
            self.resumed = False

    def run(self, batches, *, steps: Optional[int] = None):
        """Iterate batches; yields (step, metrics).  When the batches run
        out (or ``steps`` is reached), the last step's state is saved."""
        for batch in batches:
            if steps is not None and self.step >= steps:
                break
            metrics = self._one_step(batch)
            yield self.step, metrics
            self.step += 1
        self.ckpt.save_async(self.state, self.step - 1)
        self.ckpt.wait()

    def _one_step(self, batch):
        t0 = time.perf_counter()

        def _attempt():
            nonlocal t0
            t0 = time.perf_counter()   # straggler timing covers the attempt
            self.state, metrics = self.step_fn(self.state, batch)
            return metrics

        def _restore_before_retry(attempt, exc):
            # the newest published checkpoint, like a relaunch; the step
            # counter and the batch stay (the reference's quirk)
            if latest_step(self.ckpt.directory) is not None:
                self.state, _ = restore(self.state, self.ckpt.directory, device=self.device)

        # every step failure is treated as a preemption and replayed (the
        # training loop's contract predates fault classification); the
        # service passes the stricter ``is_transient`` instead
        metrics = retry_call(
            _attempt,
            retries=self.max_retries,
            seed=self.step,
            base_s=0.01,
            should_retry=lambda e: True,
            on_retry=_restore_before_retry,
        )
        dt = time.perf_counter() - t0
        ewma = dt if self.ewma is None else 0.9 * self.ewma + 0.1 * dt
        if self.ewma is not None and dt > self.straggler_factor * self.ewma:
            self.stragglers.append(StragglerEvent(self.step, dt, self.ewma))
        self.ewma = ewma
        self.heartbeat.beat(self.step)
        if self.step % self.ckpt_every == 0 and self.step > 0:
            self.ckpt.save_async(self.state, self.step)
        return metrics
