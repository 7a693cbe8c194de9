"""sweep.device_ms: Device milliseconds per sweep over the traced slice:
every device operation's time summed (overlaps counted twice), over the
slice's sweeps.
"""


def read(observed):
    trace = observed.get("trace")
    if trace is None:
        return None
    return 1e3 * trace["device_s"] / trace["sweeps"]
