from .kernel import flash_attention_raw, launches
from .ops import flash_attention
from .ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_raw", "flash_attention_ref",
           "launches"]
