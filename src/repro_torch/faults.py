"""`repro_torch.faults`: deterministic, seedable fault injection (port of
``repro/faults.py``, host-only).

Chaos testing only works when the chaos is *reproducible*: a failure the
harness provoked must be re-provokable from the same seed, or the test
that caught it cannot be rerun.  This module gives the whole stack ONE
injection mechanism:

  * **named sites** — the places a production failure can actually enter
    the system (:data:`SITES`, the reference's names).  The port fires
    ``io.parse`` (AIGER parsing), ``exec.prefetch`` (the streaming
    executor's prefetch thread), ``exec.launch`` (a packed device launch)
    and ``cache.load`` (the result cache and the partition journal); the
    others belong to routes not ported yet.  Each site is a single :func:`fire` call in the
    product code; when no plan is installed that call is one global read
    and a ``None`` check.
  * **a FaultPlan** — per-site trigger specs (probability, exact
    nth-call, every-nth, latency, substring ``match`` against the call's
    tag) and an exception *kind* (transient / fatal / resource / kill /
    latency-only), all derived from one seed, so two runs of the same
    plan fail the same calls.
  * **one activation path** — :func:`install`, :class:`injected`, or the
    ``$REPRO_FAULT_PLAN`` environment variable (read once at import).

Plan spec grammar (also accepted as a JSON list of spec dicts)::

    site:key=value,key=value[;site:key=value,...]
    # 20% transient device failures, poison any tag containing "bad":
    service.device:p=0.2,kind=transient;service.device:match=bad,kind=fatal

Exception kinds map to classes the product code can classify:
:class:`TransientFault` (retryable), :class:`FatalFault` (never
retried), :class:`ResourceFault` (triggers the streaming executor's
capacity degradation), and :class:`WorkerKilled` — a ``BaseException``
that deliberately escapes worker-thread exception forwarding, i.e. an
abrupt thread death the watchdogs must detect.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import threading
import time
from typing import Optional

import torch

#: the named injection points wired into the product code
SITES = (
    "io.parse",         # AIGER parsing (the reference's io.aiger.loads)
    "exec.prefetch",    # streaming executor's host prefetch thread
    "exec.launch",      # streaming executor's packed device launch
    "mesh.launch",      # sharded executor's per-device lane launch
    "service.prepare",  # service prepare-pool task
    "service.device",   # service device-worker pack/stream call
    "cache.load",       # result-cache / partition-journal load
)

#: environment variable holding a plan spec, read once at import time —
#: how CI chaos lanes activate injection without touching code
PLAN_ENV = "REPRO_FAULT_PLAN"


class FaultError(RuntimeError):
    """Base class of every injected failure (except :class:`WorkerKilled`)."""


class TransientFault(FaultError):
    """An injected failure that a retry is expected to clear."""


class FatalFault(FaultError):
    """An injected failure that retrying can never clear (poisoned input)."""


class ResourceFault(FaultError):
    """An injected device resource exhaustion (triggers degradation)."""


class WorkerKilled(BaseException):
    """Simulated abrupt worker-thread death.

    Derives from ``BaseException`` and is deliberately NOT forwarded by
    worker-thread ``except`` clauses — the thread just dies, which is
    what an OS kill looks like.  Watchdogs must notice its absence.
    """


_KIND_EXC = {
    "transient": TransientFault,
    "fatal": FatalFault,
    "resource": ResourceFault,
    "kill": WorkerKilled,
}

#: kinds that only delay the call instead of failing it
_LATENCY_ONLY = ("latency", "delay")


@dataclasses.dataclass(frozen=True)
class SiteSpec:
    """One trigger rule at one site."""

    site: str
    p: float = 0.0                 # per-call trigger probability
    nth: Optional[int] = None      # trigger exactly the nth matching call (1-based)
    every: Optional[int] = None    # trigger every nth matching call
    latency_s: float = 0.0         # injected sleep when triggered
    kind: str = "transient"        # transient|fatal|resource|kill|latency
    match: Optional[str] = None    # only calls whose tag contains this substring
    max_fires: Optional[int] = None  # stop triggering after this many fires

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r} (know {SITES})")
        if self.kind not in _KIND_EXC and self.kind not in _LATENCY_ONLY:
            raise ValueError(
                f"unknown fault kind {self.kind!r} "
                f"(know {sorted(_KIND_EXC)} + {list(_LATENCY_ONLY)})"
            )

    def to_spec(self) -> str:
        parts = [self.site + ":"]
        kv = []
        if self.p:
            kv.append(f"p={self.p}")
        if self.nth is not None:
            kv.append(f"nth={self.nth}")
        if self.every is not None:
            kv.append(f"every={self.every}")
        if self.latency_s:
            kv.append(f"latency={self.latency_s}")
        if self.match is not None:
            kv.append(f"match={self.match}")
        if self.max_fires is not None:
            kv.append(f"max_fires={self.max_fires}")
        kv.append(f"kind={self.kind}")
        return parts[0] + ",".join(kv)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded set of :class:`SiteSpec` rules — the unit of activation."""

    specs: tuple = ()
    seed: int = 0

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Parse the compact spec grammar (or a JSON list of spec dicts).

        ``seed=N`` may appear inside any site's key/value list; the last
        one wins for the whole plan.
        """
        text = text.strip()
        if not text:
            return cls()
        if text.startswith(("[", "{")):
            raw = json.loads(text)
            if isinstance(raw, dict):
                seed = int(raw.pop("seed", 0))
                raw = raw.get("specs", [])
            else:
                seed = 0
            return cls(specs=tuple(SiteSpec(**d) for d in raw), seed=seed)
        specs: list[SiteSpec] = []
        seed = 0
        for clause in text.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            site, sep, body = clause.partition(":")
            if not sep:
                raise ValueError(f"bad fault clause {clause!r} (want site:k=v,...)")
            kw: dict = {"site": site.strip()}
            for item in body.split(","):
                item = item.strip()
                if not item:
                    continue
                k, sep, v = item.partition("=")
                if not sep:
                    raise ValueError(f"bad fault option {item!r} in {clause!r}")
                k = k.strip()
                v = v.strip()
                if k == "seed":
                    seed = int(v)
                elif k == "p":
                    kw["p"] = float(v)
                elif k in ("nth", "every", "max_fires"):
                    kw[k] = int(v)
                elif k in ("latency", "latency_s"):
                    kw["latency_s"] = float(v)
                elif k in ("kind", "match"):
                    kw[k] = v
                else:
                    raise ValueError(f"unknown fault option {k!r} in {clause!r}")
            specs.append(SiteSpec(**kw))
        return cls(specs=tuple(specs), seed=seed)

    @classmethod
    def coerce(cls, plan) -> "FaultPlan":
        """A :class:`FaultPlan` from a plan, a spec string, or None."""
        if plan is None:
            return cls()
        if isinstance(plan, cls):
            return plan
        return cls.parse(str(plan))

    def to_spec(self) -> str:
        """Round-trippable spec string (what ``$REPRO_FAULT_PLAN`` holds)."""
        clauses = [s.to_spec() for s in self.specs]
        if self.seed and clauses:
            clauses[0] += f",seed={self.seed}"
        return ";".join(clauses)

    def __bool__(self) -> bool:
        return bool(self.specs)


class FaultInjector:
    """Evaluates a :class:`FaultPlan` at every :func:`fire` call.

    Deterministic: each spec draws from its own ``random.Random`` seeded
    from ``(plan.seed, site, spec index)`` as a string (string seeding is
    stable across processes, unlike hash-based tuple seeding), and
    nth/every counters count only calls the spec's ``match`` accepts.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._by_site: dict[str, list] = {}
        for i, spec in enumerate(plan.specs):
            rng = random.Random(f"{plan.seed}:{spec.site}:{i}")
            # [spec, rng, matching-call count, fire count]
            self._by_site.setdefault(spec.site, []).append([spec, rng, 0, 0])
        self.calls: dict[str, int] = {}
        self.fired: dict[str, int] = {}

    def check(self, site: str, tag: Optional[str] = None) -> None:
        """Raise / sleep according to the plan; no-op for unplanned sites."""
        rules = self._by_site.get(site)
        with self._lock:
            self.calls[site] = self.calls.get(site, 0) + 1
            if not rules:
                return
            verdict = None    # (spec, exc_class or None)
            for rule in rules:
                spec, rng, _, fires = rule
                if spec.match is not None and spec.match not in (tag or ""):
                    continue
                rule[2] += 1
                n = rule[2]
                if spec.max_fires is not None and fires >= spec.max_fires:
                    continue
                hit = (
                    (spec.nth is not None and n == spec.nth)
                    or (spec.every is not None and n % spec.every == 0)
                    or (spec.p > 0.0 and rng.random() < spec.p)
                )
                if not hit:
                    continue
                rule[3] += 1
                self.fired[site] = self.fired.get(site, 0) + 1
                verdict = (spec, _KIND_EXC.get(spec.kind))
                break
        if verdict is None:
            return
        spec, exc_cls = verdict
        if spec.latency_s > 0.0:
            time.sleep(spec.latency_s)
        if exc_cls is not None:
            detail = f" (tag={tag!r})" if tag else ""
            raise exc_cls(f"injected {spec.kind} fault at {site}{detail}")

    def stats(self) -> dict:
        with self._lock:
            return {"calls": dict(self.calls), "fired": dict(self.fired)}


#: the installed injector; None means every ``fire()`` is a cheap no-op
_ACTIVE: Optional[FaultInjector] = None


def fire(site: str, tag: Optional[str] = None) -> None:
    """The product-code hook: evaluate the active plan at ``site``.

    The inactive path (no plan installed — i.e. production) is a single
    global load and ``None`` check; keep call sites coarse-grained (per
    parse / per launch, never per node) and this stays unmeasurable.
    ``tag`` may be a zero-arg callable — it is only evaluated when a plan
    is active, so call sites can attach identity tags without paying for
    their construction in production.
    """
    inj = _ACTIVE
    if inj is not None:
        inj.check(site, tag() if callable(tag) else tag)


def install(plan) -> Optional[FaultInjector]:
    """Install a plan (FaultPlan | spec string | None) process-wide;
    returns the injector (None when the plan is empty)."""
    global _ACTIVE
    plan = FaultPlan.coerce(plan)
    _ACTIVE = FaultInjector(plan) if plan else None
    return _ACTIVE


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[FaultInjector]:
    return _ACTIVE


class injected:
    """Context manager for tests: install a plan, restore on exit."""

    def __init__(self, plan):
        self.plan = plan
        self._prev: Optional[FaultInjector] = None

    def __enter__(self) -> Optional[FaultInjector]:
        global _ACTIVE
        self._prev = _ACTIVE
        return install(self.plan)

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self._prev


def is_resource_error(exc: BaseException) -> bool:
    """Classify device resource exhaustion — the trigger for the streaming
    executor's capacity degradation.  Covers injected :class:`ResourceFault`,
    host ``MemoryError``, PyTorch's ``torch.cuda.OutOfMemoryError`` (whose
    message reads "CUDA out of memory"), and the reference's
    RESOURCE_EXHAUSTED / "Out of memory" runtime errors (matched by
    message)."""
    if isinstance(exc, (ResourceFault, MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    msg = str(exc)
    return any(m in msg for m in ("RESOURCE_EXHAUSTED", "Out of memory", "CUDA out of memory"))


# import-time env activation: CI chaos lanes export $REPRO_FAULT_PLAN and
# run unmodified entry points
if os.environ.get(PLAN_ENV):
    install(os.environ[PLAN_ENV])
