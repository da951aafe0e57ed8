from .timing import Timed

__all__ = ["Timed"]
