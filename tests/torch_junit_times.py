"""Where the suite's time goes, from the JUnit report of a pytest run (the
Tier-1 command writes one with ``--junitxml``).

    python tests/torch_junit_times.py REPORT.xml [AFTER.xml] [--top N]

Prints the report's pass count and the time summed over its test cases
(under ``-n 6`` the workers' time, not the wall time), the time of the
port's tests (``tests/test_torch_*.py``) and of the rest, the N slowest
files and tests. Given a second report, it prints both side by side and
lists every test that passed in the first and does not pass in the second.
"""

import argparse
import collections
import xml.etree.ElementTree as ET


def read(path):
    """{test id: (seconds, outcome)} of a JUnit report; the outcome is
    'passed', 'failed', 'error' or 'skipped'."""
    cases = {}
    for case in ET.parse(path).getroot().iter('testcase'):
        module = case.get('classname', '').split('.')
        # classname "tests.test_x" or "tests.test_x.TestClass"
        file = '/'.join(module[:2]) + '.py' if len(module) >= 2 else '?'
        cls = '::'.join(module[2:])
        tid = '::'.join(p for p in (file, cls, case.get('name')) if p)
        outcome = 'passed'
        for tag in ('failure', 'error', 'skipped'):
            if case.find(tag) is not None:
                outcome = {'failure': 'failed'}.get(tag, tag)
        cases[tid] = (float(case.get('time', 0)), outcome)
    return cases


def summary(cases):
    files = collections.Counter()
    for tid, (sec, _) in cases.items():
        files[tid.split('::')[0]] += sec
    port = sum(s for f, s in files.items()
               if f.startswith('tests/test_torch_'))
    return {'passed': sum(o == 'passed' for _, o in cases.values()),
            'total_s': sum(s for s, _ in cases.values()),
            'port_s': port, 'files': files}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('reports', nargs='+')
    ap.add_argument('--top', type=int, default=20)
    args = ap.parse_args(argv)
    runs = [read(p) for p in args.reports[:2]]
    sums = [summary(c) for c in runs]
    for path, s in zip(args.reports, sums):
        print(f'{path}: {s["passed"]} passed; summed test time '
              f'{s["total_s"]:.1f} s, port tests {s["port_s"]:.1f} s, '
              f'the rest {s["total_s"] - s["port_s"]:.1f} s')
    if len(sums) == 2:
        b, a = sums
        print(f'port tests: {b["port_s"]:.1f} s -> {a["port_s"]:.1f} s '
              f'({100 * (1 - a["port_s"] / b["port_s"]):.1f}% less)')
    for i, (path, s) in enumerate(zip(args.reports, sums)):
        print(f'\nslowest port files, {path}:')
        port_files = [(f, t) for f, t in s['files'].most_common()
                      if f.startswith('tests/test_torch_')]
        for f, t in port_files[:args.top]:
            other = (f' (other report: {sums[1 - i]["files"][f]:.1f} s)'
                     if len(sums) == 2 else '')
            print(f'  {t:8.1f} s  {f}{other}')
        print(f'\nslowest tests, {path}:')
        for tid, (sec, _) in sorted(runs[i].items(),
                                    key=lambda kv: -kv[1][0])[:args.top]:
            print(f'  {sec:8.1f} s  {tid}')
    if len(runs) == 2:
        lost = sorted(t for t, (_, o) in runs[0].items()
                      if o == 'passed' and runs[1].get(t, (0, ''))[1]
                      != 'passed')
        print(f'\npassed in {args.reports[0]}, not passed in '
              f'{args.reports[1]}: {len(lost)}')
        for t in lost:
            print(f'  {t} ({runs[1].get(t, (0, "absent"))[1]})')


if __name__ == '__main__':
    main()
