"""loop.host_syncs_per_sweep: Waits of the trainer's loop on the card (its
host_syncs counter) over the window, per sweep.
"""


def read(observed):
    return observed["host_syncs"] / observed["window_sweeps"]
