from .drift import drift_report, plan_predictions
from .metrics import OBS_SCHEMA_VERSION, Counter, Gauge, Histogram, \
    MetricsRegistry
from .programs import PROGRAMS_SCHEMA_VERSION, ProgramRegistry, program_cost
from .timing import Timed, profile_trace
from .trace import Tracer

__all__ = ["OBS_SCHEMA_VERSION", "PROGRAMS_SCHEMA_VERSION", "Counter",
           "Gauge", "Histogram", "MetricsRegistry", "ProgramRegistry",
           "Timed", "Tracer", "drift_report", "plan_predictions",
           "profile_trace", "program_cost"]
