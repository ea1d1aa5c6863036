#!/usr/bin/env python3
"""
The paper's sweeps on the port: one driver for scripts/reproduce_*.sh,
scripts/run_missing_benchmarks1.sh and scripts/streams/*.sh, which call
the JAX CLI (``python main.py``) and stay as they are.

    python -m quanonet_torch.sweeps --sweep NAME [OPERATOR] [--dry_run]
        [--device cuda|cpu] [--workdir DIR]

NAME is benchmarks1, benchmarks2, capacity, circuit, hamiltonian, scaling,
missing_benchmarks1 or stream:<name> (capacity_deeponet,
capacity_deeponet_d5, capacity_q_a, capacity_q_b, capacity_q_b2,
circuit_q10); OPERATOR is handed to the scripts that take one, as their
``${1:-Antideriv}`` (capacity, circuit, hamiltonian and scaling).  The
script is the one source of the regimes: it runs under bash with a
stand-in ``python`` first on PATH, which records each ``main.py``
argument list and exits 0, so the plan is the script's argument lists,
flag for flag and in its order.  ``--dry_run`` prints them, one regime a
line, and trains nothing.

Otherwise each regime runs as ``python -m quanonet_torch.cli <args>
--device <dev>`` in a subprocess started in ``--workdir`` (default: the
checkout's root, where the scripts ``cd``), in the scripts' order; the
first regime to exit non-zero stops the sweep with its exit code (the
scripts' ``|| exit 1``).  The quantum regimes pass ``--multi_seed 0 1 2 3
4`` and train packed (multiseed.train_seeds_packed: B1f/B1b and B4f/B4b,
B2f/B2b at Q10, on the card).  A finished regime resume-skips in the CLI,
so a rerun trains nothing.  Results go under the scripts' prefixes
(``benchmarks1_reproduction``, ...) in the metric.json layout that
scripts/collect_results.py and scripts/check_paper_orderings.py read.
The CLI runs on the card and raises without one unless ``--device cpu``.
"""
import argparse
import os
import shlex
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, 'scripts')
SWEEPS = {'benchmarks1': 'reproduce_benchmarks1.sh',
          'benchmarks2': 'reproduce_benchmarks2.sh',
          'capacity': 'reproduce_capacity.sh',
          'circuit': 'reproduce_circuit.sh',
          'hamiltonian': 'reproduce_hamiltonian.sh',
          'scaling': 'reproduce_scaling.sh',
          'missing_benchmarks1': 'run_missing_benchmarks1.sh'}
# scripts/streams/*.sh: slices of capacity and circuit, always Antideriv
STREAMS = ('capacity_deeponet', 'capacity_deeponet_d5', 'capacity_q_a',
           'capacity_q_b', 'capacity_q_b2', 'circuit_q10')
# the sweeps whose script takes the operator as its first argument
TAKES_OPERATOR = ('capacity', 'circuit', 'hamiltonian', 'scaling')

# the stand-in python: one line a call, its arguments tab-separated
SHIM = """#!/bin/sh
for a in "$@"; do printf '%s\\t' "$a" >> "$SWEEP_PLAN_LOG"; done
printf '\\n' >> "$SWEEP_PLAN_LOG"
exit 0
"""


def names():
    """Every sweep's name, the streams as stream:<name>."""
    return list(SWEEPS) + [f'stream:{s}' for s in STREAMS]


def script(sweep):
    """The path of ``sweep``'s shell script."""
    if sweep.startswith('stream:'):
        name = sweep.split(':', 1)[1]
        if name not in STREAMS:
            raise ValueError(f"unknown stream {name!r}; the sweeps: "
                             f"{names()}")
        return os.path.join(SCRIPTS, 'streams', name + '.sh')
    if sweep not in SWEEPS:
        raise ValueError(f"unknown sweep {sweep!r}; the sweeps: {names()}")
    return os.path.join(SCRIPTS, SWEEPS[sweep])


def plan(sweep, operator=None):
    """The regimes of ``sweep``, each the argument list its script hands
    ``main.py``, in the script's order: the script run under bash with the
    stand-in python (SHIM) first on PATH."""
    path = script(sweep)
    if operator is not None and sweep not in TAKES_OPERATOR:
        raise ValueError(f"sweep {sweep!r} takes no operator (only "
                         f"{', '.join(TAKES_OPERATOR)})")
    with tempfile.TemporaryDirectory() as tmp:
        shim, log = os.path.join(tmp, 'python'), os.path.join(tmp, 'log')
        with open(shim, 'w') as f:
            f.write(SHIM)
        os.chmod(shim, 0o755)
        open(log, 'w').close()
        env = dict(os.environ, SWEEP_PLAN_LOG=log,
                   PATH=os.pathsep.join((tmp, os.environ.get('PATH', ''))))
        subprocess.run(['bash', path, *([operator] if operator else [])],
                       env=env, check=True, stdout=subprocess.DEVNULL,
                       timeout=120)
        with open(log) as f:
            calls = [line.split('\t')[:-1] for line in f.read().splitlines()]
    for call in calls:
        if call[:1] != ['main.py']:
            raise ValueError(f"{path} called python with {call[:2]}, not "
                             f"main.py")
    return [call[1:] for call in calls]


def with_flags(argv, **flags):
    """``argv`` with each ``--name`` of ``flags`` given the value(s)
    ``flags[name]`` (a string or a list), in place where the flag is,
    appended where it is not."""
    out = list(argv)
    for name, value in flags.items():
        values = [str(v) for v in (value if isinstance(value, (list, tuple))
                                   else [value])]
        flag = f'--{name}'
        if flag in out:
            i = out.index(flag)
            j = i + 1
            while j < len(out) and not out[j].startswith('--'):
                j += 1
            out[i + 1:j] = values
        else:
            out += [flag, *values]
    return out


def run(regimes, device, workdir=REPO, log=None):
    """Each regime through ``python -m quanonet_torch.cli <args> --device
    <device>`` in a subprocess started in ``workdir``, in order; the first
    non-zero exit ends the sweep.  ``log``, an open file, takes the
    subprocesses' output (default: this process's).  -> (exit code, one
    {"argv", "rc", "seconds"} a regime run)."""
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        p for p in (REPO, env.get('PYTHONPATH')) if p)
    done = []
    for i, argv in enumerate(regimes):
        cmd = [sys.executable, '-m', 'quanonet_torch.cli', *argv,
               '--device', device]
        print(f"▶ [{i + 1}/{len(regimes)}] {shlex.join(argv)}", flush=True)
        t0 = time.time()
        rc = subprocess.run(cmd, cwd=workdir, env=env, stdout=log,
                            stderr=subprocess.STDOUT if log else None
                            ).returncode
        done.append({"argv": argv, "rc": rc, "seconds": time.time() - t0})
        if rc != 0:
            print(f"✗ regime {i + 1} exited {rc}; the sweep stops",
                  flush=True)
            return rc, done
    return 0, done


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--sweep', required=True, choices=names())
    ap.add_argument('operator', nargs='?', default=None,
                    help=f"the operator of {', '.join(TAKES_OPERATOR)} "
                         f"(default Antideriv)")
    ap.add_argument('--dry_run', action='store_true',
                    help='print each regime\'s argument list and run none')
    ap.add_argument('--device', default='cuda', help='cuda or cpu')
    ap.add_argument('--workdir', default=REPO,
                    help='where the runs start (the prefixes are relative '
                         'to it; default: the checkout\'s root)')
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    regimes = plan(args.sweep, args.operator)
    if args.dry_run:
        for r in regimes:
            print(shlex.join(r))
        return 0
    from quanonet_torch import resolve_device
    resolve_device(args.device)      # no card: raise before any regime
    rc, done = run(regimes, args.device, args.workdir)
    print(f"{'✅' if rc == 0 else '✗'} {args.sweep}: "
          f"{len(done)}/{len(regimes)} regimes run, exit {rc}", flush=True)
    return rc


if __name__ == '__main__':
    sys.exit(main())
