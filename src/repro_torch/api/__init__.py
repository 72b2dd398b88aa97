"""The port's public front door: :class:`Session` over the full-graph route."""
from repro_torch.api.config import SessionConfig
from repro_torch.api.session import RoutingDecision, Session, SessionResult, route_prepared

__all__ = ["RoutingDecision", "Session", "SessionConfig", "SessionResult", "route_prepared"]
