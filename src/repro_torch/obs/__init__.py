from .drift import drift_report, plan_predictions
from .timing import Timed, profile_trace

__all__ = ["Timed", "drift_report", "plan_predictions", "profile_trace"]
