"""device.idle_pct: Share of a sweep's time (%) in which no operation runs
on the card: one minus the device's busy time per sweep (the union of
the device intervals in the traced slice, over its sweeps) over the mean
time of a sweep outside the slice (the traced run's sweeps per second,
which leave the slice out).  The busy time is the card's own; the sweep
time is not taken inside the slice, because the profiler slows the host
there and the card waits on it.
"""


def read(observed):
    trace = observed.get("trace")
    if trace is None or not trace["sweeps"]:
        return None
    busy_ms = 1e3 * trace["busy_s"] / trace["sweeps"]
    return 100.0 * (1.0 - busy_ms * observed["sweeps_per_s"] / 1e3)
