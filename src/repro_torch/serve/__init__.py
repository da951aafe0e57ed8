from .disagg import DisaggEngine
from .engine import EngineStats, Request, ServeEngine, bucket_for, prefill_buckets
from .kvpool import PagedKVManager
from .sampling import sample_tokens

__all__ = ["DisaggEngine", "EngineStats", "PagedKVManager", "Request",
           "ServeEngine", "bucket_for", "prefill_buckets", "sample_tokens"]
