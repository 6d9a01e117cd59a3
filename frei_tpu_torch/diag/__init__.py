from .telemetry import SolveMetrics
