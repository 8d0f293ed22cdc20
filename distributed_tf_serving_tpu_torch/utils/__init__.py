"""Utilities: config, metrics, tracing."""

from .config import ObservabilityConfig, ServerConfig, load_config
from .metrics import LatencyHistogram, ServerMetrics
from .tracing import PhaseTrace, request_trace

__all__ = [
    "ServerConfig",
    "ObservabilityConfig",
    "load_config",
    "LatencyHistogram",
    "ServerMetrics",
    "PhaseTrace",
    "request_trace",
]
