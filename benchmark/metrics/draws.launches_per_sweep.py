"""draws.launches_per_sweep: Launches of the entity-draws kernel
(ops/entity_draws.py: one a one-hot table and sweep on the card, none on
the CPU) over the window, per sweep: the program's counter
``entity_draws.launches``, read at the window's open and close.
"""

COUNTERS = {"entity_draws.launches":
            "myfm_tpu_torch.ops.entity_draws:entity_draws.launches"}


def read(observed):
    start, end = observed["counters"]["entity_draws.launches"]
    return (end - start) / observed["window_sweeps"]
