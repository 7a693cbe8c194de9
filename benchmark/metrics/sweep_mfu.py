"""sweep_mfu: The model FLOPs of one sweep (fmbench/roofline.sweep_flops)
times the traced run's sweeps per second outside its traced slice, over
the card's 989 TFLOP/s (%).
"""

from fmbench import roofline


def read(observed):
    return 100.0 * observed["sweep_flops"] * observed["sweeps_per_s"] / (
        roofline.BF16_FLOPS_PER_S)
