"""One torch intra-op thread for the port's CPU tests.

The suite runs as pytest-xdist workers that share the machine's cores (the
Tier-1 command runs 6 workers on 8 cores). On torch's default pool every
worker starts as many threads as there are cores, and the threads of the
workers then contend: six copies of ``tests/test_torch_rnn.py`` run at once
took 111.9-114.2 s each on the default pool and 49.5-50.7 s at one thread,
six of ``tests/test_torch_melgan.py`` 154.8-156.2 s against 25.9-27.2 s
(8 cores; ``tests/measure_contention.py``). The per-step recurrences,
thousands of tiny ops, and the convolutions suffer most.

Every ``tests/test_torch_*.py`` imports :func:`torch_one_thread`, an autouse
fixture of module scope, so its tests run with ``torch.get_num_threads() ==
1`` and with ``OMP_NUM_THREADS=1`` in the environment (which the ``spawn``
workers of preprocessing and duration extraction inherit). It restores
both when the module ends: JAX tests share the workers. A test that starts
a Python process passes it ``env=subprocess_env(...)``.
``tests/test_torch_thread_discipline.py`` holds every port test to both.

This is a property of how the tests share a machine, not of the program:
the port's entry points keep torch's defaults.
"""

import contextlib
import os

import pytest
import torch


@contextlib.contextmanager
def one_thread():
    """Run the block at one torch intra-op thread and with
    ``OMP_NUM_THREADS=1``; restore both afterwards."""
    threads = torch.get_num_threads()
    omp = os.environ.get('OMP_NUM_THREADS')
    torch.set_num_threads(1)
    os.environ['OMP_NUM_THREADS'] = '1'
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        if omp is None:
            os.environ.pop('OMP_NUM_THREADS', None)
        else:
            os.environ['OMP_NUM_THREADS'] = omp


@pytest.fixture(scope='module', autouse=True)
def torch_one_thread():
    """Every test of a module that imports this fixture, and its
    module-scoped fixtures, run at one torch thread (:func:`one_thread`)."""
    with one_thread():
        yield


def subprocess_env(**extra) -> dict:
    """The environment of a Python process a port test starts: this one's,
    with ``OMP_NUM_THREADS=1`` (torch's pool in the child, which a fixture
    cannot reach) and ``extra``."""
    return dict(os.environ, OMP_NUM_THREADS='1', **extra)
