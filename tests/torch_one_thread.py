"""A module-scoped autouse fixture for the port's test files: torch on
one intra-op thread while a module runs. The tier-1 command runs six
pytest processes on the same cores, and with torch's default of one
thread per core every process's small CPU kernels contend for all of
them: test_torch_spec_decode.py took 253 s of a whole run on eight
cores, and about 30 s alone. Import it into a test module:

    from torch_one_thread import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
