from .kernel import decode_launches, launches, pavlov_ssm_raw
from .ops import pavlov_ssm
from .ref import pavlov_ssm_ref

__all__ = ["decode_launches", "launches", "pavlov_ssm", "pavlov_ssm_raw",
           "pavlov_ssm_ref"]
