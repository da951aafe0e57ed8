from .drift import drift_report, plan_predictions
from .ledger import LEDGER_SCHEMA_VERSION, append_record, read_ledger, \
    trend_check
from .metrics import OBS_SCHEMA_VERSION, Counter, Gauge, Histogram, \
    MetricsRegistry
from .programs import PROGRAMS_SCHEMA_VERSION, ProgramRegistry, program_cost
from .timing import Timed, profile_trace
from .trace import Tracer

__all__ = ["LEDGER_SCHEMA_VERSION", "OBS_SCHEMA_VERSION",
           "PROGRAMS_SCHEMA_VERSION", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "ProgramRegistry", "Timed", "Tracer",
           "append_record", "drift_report", "plan_predictions",
           "profile_trace", "program_cost", "read_ledger", "trend_check"]
