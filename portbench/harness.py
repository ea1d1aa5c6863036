"""
The harness: finds a cell's pieces by name, runs its set-up and its
measured window, reads its metrics, and holds what the window produced
against the plain reference.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the name ``BENCHMARK.json`` gives it:

    portbench/configs/<config>.json    sizes, source, weights (``file``)
    portbench/traffic/<mix>.json       parameters, and the ``kind`` of
                                       driver that reads them
    portbench/kinds/<kind>.py          a driver: Cell(config, traffic,
                                       seed, device, seconds, root)
    portbench/limits/<workload>.json   each compared number's limit
    portbench/metrics/<metric>.py      read(record) -> value or None

A metric's reader gets the window's record: the driver's counts (kind,
seconds, rows, units, attempted, failed, flops, bytes, and for serving
latency_ms, service_ms), ``setup_s``, and with ``--trace 1`` the trace's
window_s, busy_s and device_rows.
"""
import argparse
import ast
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

# top-level module names the harness may not load (the JAX package and its
# stack), and those the reference may not load either (the program)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'quanonet_tpu')
FORBIDDEN_IN_REFERENCE = FORBIDDEN + ('quanonet_torch',)
PACKAGE = 'portbench'


def _json(path):
    with open(path) as fh:
        return json.load(fh)


def _imports(path, package):
    """Full names of the modules a source file of ``package`` imports, its
    relative imports resolved against that package (``from . import x``
    names ``package.x``)."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
        elif isinstance(node, ast.ImportFrom):
            parts = package.split('.')
            base = '.'.join(parts[:len(parts) - node.level + 1])
            if node.module:
                names.add(f'{base}.{node.module}')
            else:
                names.update(f'{base}.{a.name}' for a in node.names)
    return names


def import_violations(root):
    """[(file, module)]: imports of the harness's sources whose top-level
    name is forbidden; in ``reference/`` also the program and the rest of
    the harness."""
    out = []
    base = os.path.join(root, PACKAGE)
    for folder, _, files in os.walk(base):
        rel = os.path.relpath(folder, base)
        in_ref = rel.split(os.sep)[0] == 'reference'
        package = '.'.join([PACKAGE] + ([] if rel == '.' else
                                        rel.split(os.sep)))
        for name in sorted(files):
            if not name.endswith('.py'):
                continue
            path = os.path.join(folder, name)
            for mod in _imports(path, package):
                top = mod.split('.')[0]
                bad = top in (FORBIDDEN_IN_REFERENCE if in_ref else FORBIDDEN)
                if in_ref and top == PACKAGE:
                    bad = mod.split('.')[:2] != [PACKAGE, 'reference']
                if bad:
                    out.append((os.path.relpath(path, root), mod))
    return out


def loaded_forbidden():
    """Forbidden top-level names among this process's loaded modules."""
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def refuse_forbidden():
    """Ends the run, with no result, if the JAX stack is loaded."""
    found = loaded_forbidden()
    if found:
        raise SystemExit(f"modules of the JAX stack are loaded: {found}")


class Workload:
    """A workload of ``BENCHMARK.json`` with its files."""

    def __init__(self, root, name):
        self.root = root
        bench = _json(os.path.join(root, 'BENCHMARK.json'))
        self.bench = bench
        self.workload = {w['name']: w for w in bench['workloads']}[name]
        self.name = name
        cfg = {c['name']: c for c in bench['configs']}[
            self.workload['config']]
        self.config = _json(os.path.join(root, cfg['file']))
        self.traffic = _json(os.path.join(
            root, PACKAGE, 'traffic', f"{self.workload['traffic']}.json"))
        self.limits = _json(os.path.join(root, PACKAGE, 'limits',
                                         f'{name}.json'))
        self.kind = importlib.import_module(
            f"{PACKAGE}.kinds.{self.traffic['kind']}")

    def metrics(self, trace):
        """The metric entries this cell reports: with ``trace`` the
        per-layer ones, else the end-to-end ones."""
        entries = self.bench['per_layer' if trace else 'end_to_end']
        return [m for m in entries
                if self.name in m.get('workloads', [self.name])]

    def reader(self, name):
        path = os.path.join(self.root, PACKAGE, 'metrics', f'{name}.py')
        spec = importlib.util.spec_from_file_location(
            f'{PACKAGE}_metric_{name}', path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def power_limit():
    """The card's power limit as nvidia-smi gives it, or None."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def traced_window(cell_run, seconds):
    """The window under torch.profiler, after one warm unit: (the
    window's record, the trace's summary)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from portbench.frozen import busy
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        cell_run.warm_unit()
        if cuda:
            torch.cuda.synchronize()
        with record_function(busy.WINDOW_SPAN):
            window = cell_run.run_window(seconds)
    return window, busy.summarize(prof.profiler.kineto_results.events())


def run_cell(cell, seed, seconds, trace, device, t0):
    """One run of ``cell``: set-up, the window, its metrics, the check.
    Returns the result's dict; ``checks`` comes last."""
    import torch
    cuda = device.type == 'cuda'
    run = cell.kind.Cell(cell.config, cell.traffic, seed, device, seconds,
                         cell.root)
    setup_s = time.perf_counter() - t0
    if trace:
        window, summary = traced_window(run, seconds)
    else:
        window, summary = run.run_window(seconds), {}
    if cuda:
        torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    refuse_forbidden()
    record = dict(window, setup_s=setup_s, **summary)
    metrics = {}
    for entry in cell.metrics(trace):
        value = cell.reader(entry['name'])(record)
        if value is not None:
            metrics[entry['name']] = {'value': value, 'unit': entry['unit']}
    dev = {'platform': 'gpu' if cuda else 'cpu',
           'kind': torch.cuda.get_device_name(device) if cuda else 'cpu',
           'count': cell.workload['chips'], 'memory_peak_bytes': peak}
    if trace:
        dev.update(busy_s=summary['busy_s'], window_s=summary['window_s'])
    if cuda:
        dev['power_limit'] = power_limit()
    run.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = run.check(cell.limits)
    print(f"set-up {setup_s:.3f} s, window {window['seconds']:.3f} s, "
          f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    correct = window['failed'] == 0 and all(v <= lim
                                            for _, v, lim in checks)
    result = {'correct': correct, 'attempted': window['attempted'],
              'failed': window['failed'], 'metrics': metrics, 'device': dev}
    if trace:
        result['breakdown'] = {'device_ops': summary['device_ops'],
                               'idle_gaps': summary['idle_gaps']}
    result['checks'] = {name: {'value': v, 'limit': lim}
                        for name, v, lim in checks}
    return result


def parser():
    ap = argparse.ArgumentParser(description='Run one cell of the '
                                 "benchmark of quanonet_torch once.")
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap


def main(argv, root, t0):
    args = parser().parse_args(argv)
    bad = import_violations(root)
    if bad:
        print(f"forbidden imports: {bad}", file=sys.stderr)
        return 2
    cell = Workload(root, args.workload)
    import torch
    chips = cell.workload['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device('cuda', 0)
    torch.cuda.set_device(device)
    result = run_cell(cell, args.seed, args.seconds, args.trace, device, t0)
    for name, check in result['checks'].items():
        print(f"check {name}: {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    # again after the metrics' readers and the check have run
    refuse_forbidden()
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
