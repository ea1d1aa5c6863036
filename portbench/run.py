"""
Runs one cell of the benchmark of quanonet_torch once, on the card:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result's JSON; the compared numbers and their limits are the last lines
of standard error.  See portbench/README.md.
"""
import time

T0 = time.perf_counter()   # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# kernel and compiler caches at fixed paths inside the checkout, so that
# only a checkout's first run builds
os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(ROOT, '.kernels_build',
                                                  'torch_extensions')
os.environ['TRITON_CACHE_DIR'] = os.path.join(ROOT, '.kernels_build',
                                              'triton')
# libraries that would load JAX by themselves stay off it
os.environ['USE_FLAX'] = '0'
# the program runs as the configurations state: no opt-in numeric mode
for mode in ('PFUSED_BF16', 'UCOMP_BF16', 'QON_UNPIN_EXPECT', 'USE_UCOMP'):
    os.environ.pop(mode, None)

if __name__ == '__main__':
    sys.path.insert(0, ROOT)
    from portbench import harness
    sys.exit(harness.main(sys.argv[1:], ROOT, T0))
