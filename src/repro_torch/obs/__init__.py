from .timing import Timed, profile_trace

__all__ = ["Timed", "profile_trace"]
