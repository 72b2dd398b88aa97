"""The port's public front door: :class:`Session` over the full-graph,
partitioned, streamed and batched-service routes."""
from repro_torch.api.config import SessionConfig, resolve_backend_alias  # noqa: F401
from repro_torch.api.session import RoutingDecision, Session, SessionResult, route_prepared
from repro_torch.obs import Report  # noqa: F401 — Session.report()'s return type

__all__ = ["Report", "RoutingDecision", "Session", "SessionConfig", "SessionResult",
           "route_prepared"]
