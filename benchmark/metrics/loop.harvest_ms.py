"""loop.harvest_ms: Host milliseconds per sweep inside the program's
``myfm.loop.harvest`` and ``myfm.loop.drain`` spans (each counted once:
the copies of a sweep's samples and hyperparameters to the host, and
the waits for those in flight), over the measured fit's window sweeps
outside the traced slice (fmbench/spans.host_ms).  None where no span
was recorded.
"""

from fmbench import spans


def read(observed):
    recorded = observed.get("spans")
    if recorded is None or recorded["fit"] is None or not recorded["sweeps"]:
        return None
    names, _ = spans.HOST_METRICS["loop.harvest_ms"]
    return spans.host_ms(recorded["records"], recorded["fit"],
                         recorded["sweeps"], names)
