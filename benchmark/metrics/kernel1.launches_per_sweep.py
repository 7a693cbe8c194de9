"""kernel1.launches_per_sweep: Launches of kernel 1
(ops/gram.fused_tile_gram_cross, all Gram modes) over the window, per
sweep.
"""


def read(observed):
    return observed["kernel1_launches"] / observed["window_sweeps"]
