"""One torch thread for every test module of the port.

Each ``tests/test_torch_*.py`` takes the module-scoped autouse fixture
with one line::

    from torch_threads import one_torch_thread  # noqa: F401

The port's CPU tests render small images, and the suite runs in several
processes side by side.  A torch intra-op pool sized to the host's cores
in each of them spins in parallel regions that wait for descheduled
threads: a test that takes seconds alone then takes minutes.  One thread
also makes every port render in the tests the same schedule, which the
bit-equality tests compare on both sides.

``OMP_NUM_THREADS`` is set too, so that ranks and subprocesses started
meanwhile (``parallel.spawn``, the multicard script) start on one
thread.  The module scope matters: pytest sets up an autouse fixture
before the other fixtures of its scope, so the renders in a module's
own module-scoped fixtures run on one thread as well.
``tests/test_torch_host.py::test_every_port_test_file_takes_one_thread``
holds every port test file to this rule.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(threads)
