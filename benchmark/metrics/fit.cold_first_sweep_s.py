"""fit.cold_first_sweep_s: Host seconds from fit() on a design whose plan
is not cached to its first sweep done (with a synchronize): the plan
build, initialisation and the first sweep.
"""


def read(observed):
    return observed["cold_first_sweep_s"]
