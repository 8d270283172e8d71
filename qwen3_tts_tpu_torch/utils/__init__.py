from .trace import StageTimer, log_memory, memory_snapshot, profile_trace

__all__ = ["StageTimer", "profile_trace", "memory_snapshot", "log_memory"]
