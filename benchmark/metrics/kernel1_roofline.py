"""kernel1_roofline: kernel 1's share of its roofline over the traced slice
(%): the calls' bounds (fmbench/roofline.kernel1_call, from the
operands' shapes) over the device time of kernel 1's kernels (its Gram
passes and carry walks, by name, fmbench/trace.py).  The trace should
hold one Gram pass a call; where the profiler lost some, the bounds are
taken for the share of calls whose pass it holds, so that a lost call
does not raise the share.  A trace with no pass gives nothing.
"""


def read(observed):
    trace = observed.get("trace")
    if trace is None or not trace["kernel1_passes"]:
        return None
    bounds = trace["kernel1_bound_ms"]
    held = min(1.0, trace["kernel1_passes"] / len(bounds))
    return 100.0 * sum(bounds) * held / trace["kernel1_device_ms"]
