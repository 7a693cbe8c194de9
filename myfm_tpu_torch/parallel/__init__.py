"""Multi-device training and serving over ``torch.distributed``.

The PyTorch counterpart of ``myfm_tpu/parallel/``: one process per
device, rows split contiguously across the ranks, weights,
hyperparameters and the generator replicated, statistics summed with
collectives at the points where the TPU package ``psum``s
(``collectives.Axis``).  ``sharding.py`` shards the row-space plans,
``sharding_categorical.py`` the fast-path plans.
"""
