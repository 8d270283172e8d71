from .trace import memory_snapshot, print_report, profile_trace

__all__ = ["profile_trace", "memory_snapshot", "print_report"]
