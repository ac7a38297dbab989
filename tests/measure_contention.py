"""Time copies of one port test file run at once, with torch at one intra-op
thread (as the port's tests run, tests/torch_cpu.py) or on torch's default
pool, to see what the suite's workers cost each other on this machine.

    python tests/measure_contention.py tests/test_torch_rnn.py \\
        [--copies 6] [--modes one pool]

Each mode starts ``--copies`` pytest processes of the file together (the
Tier-1 command runs 6 workers) and prints, per copy, the time pytest
reports and its summary line. In mode ``pool`` this module is loaded as a
pytest plugin (``-p measure_contention``), which hands the test modules a
fixture that leaves torch's thread pool alone. Neither mode sets
``OMP_NUM_THREADS``.
"""

import argparse
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent


def pytest_configure(config):
    """As a plugin: replace the one-thread fixture before the test modules
    import it, so they run on torch's default pool."""
    import torch_cpu

    @pytest.fixture(scope='module', autouse=True)
    def torch_one_thread():
        yield

    torch_cpu.torch_one_thread = torch_one_thread


def run(file, copies, mode):
    """[(seconds pytest reports, summary line)] of ``copies`` pytest
    processes of ``file`` started together."""
    env = dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=os.pathsep.join(
        p for p in (str(TESTS), os.environ.get('PYTHONPATH')) if p))
    env.pop('OMP_NUM_THREADS', None)
    plugin = ['-p', 'measure_contention'] if mode == 'pool' else []
    procs = []
    with tempfile.TemporaryDirectory(prefix='contention_') as tmp:
        for i in range(copies):
            cmd = [sys.executable, '-m', 'pytest', '-o', 'addopts=', '-q',
                   '-p', 'no:cacheprovider', *plugin,
                   '--basetemp', str(Path(tmp) / str(i)), str(file)]
            procs.append(subprocess.Popen(cmd, cwd=str(REPO), env=env,
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        results = []
        for proc in procs:
            out = proc.communicate()[0].strip().splitlines()
            last = out[-1] if out else ''
            m = re.search(r' in ([0-9.]+)s', last)
            results.append((float(m.group(1)) if m else float('nan'), last))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('file')
    ap.add_argument('--copies', type=int, default=6)
    ap.add_argument('--modes', nargs='+', default=['pool', 'one'],
                    choices=['pool', 'one'])
    args = ap.parse_args(argv)
    print(f'{args.file}: {args.copies} copies at once, {os.cpu_count()} '
          'cores')
    for mode in args.modes:
        results = run(args.file, args.copies, mode)
        secs = [s for s, _ in results]
        print(f'  {mode}: {min(secs):.1f}-{max(secs):.1f} s per copy')
        for s, last in results:
            print(f'    {last}')


if __name__ == '__main__':
    main()
