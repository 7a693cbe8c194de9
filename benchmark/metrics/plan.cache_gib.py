"""plan.cache_gib: Device memory the plan cache holds at the window's open
(GiB).
"""


def read(observed):
    return observed["plan_cache_bytes"] / 2 ** 30
