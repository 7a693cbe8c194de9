"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
root of the repository (the CPU; the tests marked ``cuda`` skip there
and run on the card)."""

import os
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for path in (str(BENCH), str(BENCH.parent)):
    if path not in sys.path:
        sys.path.insert(0, path)

# a design small enough for the CPU that still takes the fast path
TINY = dict(rank=8, sweep_strategy="categorical",
            dataset=dict(rows=20_000, users=300, items=120, days=50))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        # test workers share the cores: a thread pool the size of the
        # machine in each makes their small operations wait on each other
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(workers)))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
