from .kernel import launches, paged_decode_attention_raw
from .ops import paged_attention, paged_decode_attention, scatter_paged
from .ref import paged_attention_ref

__all__ = ["launches", "paged_attention", "paged_attention_ref",
           "paged_decode_attention", "paged_decode_attention_raw",
           "scatter_paged"]
