"""Observability plane: metrics, tracing, flight recorder, ops journal and
device telemetry, each process-local."""
