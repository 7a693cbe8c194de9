"""The harvest timing tool (``myfm_tpu_torch.tools.harvest``) on the
CPU: it refuses to run without a card, and its "views" variant of
``_HostCopy.wait`` reads a copy as the loop's own ``wait`` does."""

import numpy as np
import pytest
import torch

from myfm_tpu_torch import trainer as ttrainer
from myfm_tpu_torch.tools import harvest


def test_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        harvest.main(["--sweeps", "2", "--rounds", "1"])


def test_views_wait_reads_what_wait_reads():
    t = torch.arange(6.0).reshape(2, 3)
    a = ttrainer._HostCopy([t, t.sum()])
    b = ttrainer._HostCopy([t, t.sum()])
    for x, y in zip(a.wait(), harvest._wait_views(b)):
        np.testing.assert_array_equal(x, y)
