"""fit.warm_first_sweep_s: Host seconds from the measured fit's call, which
finds its plan in the cache, to its first sweep done: the fingerprint,
initialisation and the first sweep.
"""


def read(observed):
    return observed["warm_first_sweep_s"]
