"""Every port test runs torch at one intra-op thread (tests/torch_cpu.py).

Each ``tests/test_torch_*.py`` imports the autouse fixture
``torch_cpu.torch_one_thread``, and every Python process that a port test
or one of its helpers (``tests/torch_*.py``) starts gets
``OMP_NUM_THREADS=1`` in its environment: ``env=subprocess_env(...)``, or an
``OMP_NUM_THREADS='1'`` keyword. Without either, torch's default pool in
each of the suite's xdist workers contends with the others' for the cores,
and the Tier-1 run slows past its limit.
"""

import ast
import os
from pathlib import Path

import pytest
import torch
from torch_cpu import (  # noqa: F401 (torch_one_thread: a fixture)
    one_thread, subprocess_env, torch_one_thread)

TESTS = Path(__file__).resolve().parent
SPAWNERS = {'run', 'Popen', 'call', 'check_call', 'check_output'}


def imports_helper(source: str) -> bool:
    """True when the module imports ``torch_one_thread`` from ``torch_cpu``
    at its top level."""
    return any(isinstance(node, ast.ImportFrom) and node.module == 'torch_cpu'
               and any(a.name == 'torch_one_thread' for a in node.names)
               for node in ast.parse(source).body)


def _sets_one_thread(env: ast.AST) -> bool:
    for node in ast.walk(env):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == 'subprocess_env':
            return True
        if isinstance(node, ast.keyword) and node.arg == 'OMP_NUM_THREADS' \
                and isinstance(node.value, ast.Constant) \
                and node.value.value == '1':
            return True
    return False


def bare_process_calls(source: str) -> list:
    """Lines of the module's calls that start a process (``subprocess.run``,
    ``Popen``, ``call``, ``check_call``, ``check_output``, also imported by
    name, and ``os.system`` / ``os.popen``) without ``OMP_NUM_THREADS=1`` in
    their ``env``."""
    tree = ast.parse(source)
    by_name = {a.asname or a.name for node in ast.walk(tree)
               if isinstance(node, ast.ImportFrom)
               and node.module == 'subprocess'
               for a in node.names if a.name in SPAWNERS}
    bad = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id == 'os' and f.attr in ('system', 'popen'):
            bad.append(node.lineno)
            continue
        spawns = (isinstance(f, ast.Attribute) and f.attr in SPAWNERS
                  and isinstance(f.value, ast.Name)
                  and f.value.id == 'subprocess') \
            or (isinstance(f, ast.Name) and f.id in by_name)
        if not spawns:
            continue
        env = [k.value for k in node.keywords if k.arg == 'env']
        if not (env and _sets_one_thread(env[0])):
            bad.append(node.lineno)
    return bad


def _port_test_files():
    return sorted(TESTS.glob('test_torch_*.py'))


def test_every_port_test_module_takes_the_one_thread_fixture():
    files = _port_test_files()
    assert len(files) >= 40
    missing = [p.name for p in files
               if not imports_helper(p.read_text(encoding='utf-8'))]
    assert not missing, missing


@pytest.mark.parametrize('pattern', ['test_torch_*.py', 'torch_*.py'])
def test_every_process_a_port_test_starts_has_one_omp_thread(pattern):
    files = sorted(TESTS.glob(pattern))
    assert files
    bad = {p.name: lines for p in files
           if (lines := bare_process_calls(p.read_text(encoding='utf-8')))}
    assert not bad, bad


def test_this_module_runs_at_one_thread():
    assert torch.get_num_threads() == 1
    assert os.environ['OMP_NUM_THREADS'] == '1'


def test_one_thread_restores_the_worker(monkeypatch):
    monkeypatch.delenv('OMP_NUM_THREADS')
    threads = torch.get_num_threads()
    torch.set_num_threads(3)
    try:
        with one_thread():
            assert torch.get_num_threads() == 1
            assert os.environ['OMP_NUM_THREADS'] == '1'
        assert torch.get_num_threads() == 3
        assert 'OMP_NUM_THREADS' not in os.environ
    finally:
        torch.set_num_threads(threads)


def test_subprocess_env_sets_one_omp_thread(monkeypatch):
    monkeypatch.setenv('OMP_NUM_THREADS', '8')
    env = subprocess_env(RANK='1')
    assert env['OMP_NUM_THREADS'] == '1' and env['RANK'] == '1'
    assert env['PATH'] == os.environ['PATH']


@pytest.mark.parametrize('source, ok', [
    ('from torch_cpu import torch_one_thread\n', True),
    ('from torch_cpu import (subprocess_env, torch_one_thread)\n', True),
    ('from torch_cpu import subprocess_env\n', False),
    ('import torch\n', False),
    ('def f():\n    from torch_cpu import torch_one_thread\n', False),
])
def test_the_guard_finds_a_module_without_the_fixture(source, ok):
    assert imports_helper(source) is ok


@pytest.mark.parametrize('source, bad', [
    ('import subprocess\nsubprocess.run(["x"], env=subprocess_env())\n', []),
    ('import subprocess, os\n'
     'subprocess.Popen(cmd, env=dict(os.environ, OMP_NUM_THREADS="1"))\n', []),
    ('import subprocess\nsubprocess.run(["x"])\n', [2]),
    ('import subprocess, os\nsubprocess.run(["x"], env=dict(os.environ))\n',
     [2]),
    ('import subprocess, os\n'
     'subprocess.check_output(c, env=dict(os.environ, OMP_NUM_THREADS="4"))\n',
     [2]),
    ('from subprocess import Popen as P\nP(["x"])\n', [2]),
    ('import os\nos.system("python -c 1")\n', [2]),
])
def test_the_guard_finds_a_process_without_one_thread(source, bad):
    assert bare_process_calls(source) == bad
