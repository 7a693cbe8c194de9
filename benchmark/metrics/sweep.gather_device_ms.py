"""sweep.gather_device_ms: Device milliseconds per sweep of the operations
launched inside the program's ``myfm.sweep.gather`` spans (each table's
gathers of the other tables' [w | V | qs] rows for kernel 1), over the
traced slice: each device operation counted under the innermost program
span holding its launch (fmbench/spans.device_split).  None where the
slice holds no such operation.
"""


def read(observed):
    trace = observed.get("trace")
    if trace is None:
        return None
    ms = trace["span_device_ms"].get("myfm.sweep.gather")
    return None if ms is None else ms / trace["sweeps"]
