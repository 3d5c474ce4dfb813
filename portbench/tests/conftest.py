"""The benchmark's own tests, run apart from the repository's suite:

    python -m pytest portbench/tests

They import the harness (``portbench/``) and the program (``src/``)."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (BENCH, BENCH.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture(autouse=True)
def one_thread():
    """The CPU runs' small ops are slower on many threads than on one."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
