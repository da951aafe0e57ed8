from .kernel import launches, pavlov_lstm_raw
from .ops import lstm_recurrence, pavlov_lstm
from .ref import pavlov_lstm_ref

__all__ = ["launches", "lstm_recurrence", "pavlov_lstm", "pavlov_lstm_raw",
           "pavlov_lstm_ref"]
