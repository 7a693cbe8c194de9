from . import benchmark_data, callbacks, dummy_data, encoders

__all__ = ["encoders", "callbacks", "benchmark_data", "dummy_data"]
