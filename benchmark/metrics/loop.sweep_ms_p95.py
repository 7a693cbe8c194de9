"""loop.sweep_ms_p95: 95th percentile of the gaps (ms) between the CUDA
events the window's callback records after each sweep; nothing
synchronises between them.  In a traced run the gaps that the traced
slice touches (its sweeps, the profiler's start and stop) are left out.
"""

import statistics


def read(observed):
    gaps = observed["sweep_ms"]
    if len(gaps) < 20:
        return None
    return statistics.quantiles(gaps, n=20)[18]
