"""Observability helpers: the package logger and the per-iteration tracer
the lockstep L-BFGS-B emits through (:mod:`.telemetry`)."""

from .telemetry import debug_enabled, get_logger, iteration_tracer

__all__ = ["debug_enabled", "get_logger", "iteration_tracer"]
