"""The benchmark's own tests: the harness, the traffic generator, the
counting functions and the comparison that decides ``correct``, on the
CPU at tiny sizes (the program's plain paths)."""
from __future__ import annotations

import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))


@pytest.fixture(autouse=True, scope='session')
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
