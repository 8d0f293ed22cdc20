"""Utilities: config, metrics, tracing."""

from .config import ObservabilityConfig, ServerConfig, load_config
from .metrics import LatencyHistogram, ServerMetrics
from .tracing import PhaseTrace, profile_trace, request_trace

__all__ = [
    "ServerConfig",
    "ObservabilityConfig",
    "load_config",
    "LatencyHistogram",
    "ServerMetrics",
    "PhaseTrace",
    "profile_trace",
    "request_trace",
]
