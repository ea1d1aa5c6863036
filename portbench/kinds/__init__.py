"""The drivers of the benchmark's cells, one module a kind of traffic."""
import sys
import time


class Stages:
    """Prints how long each stage of a set-up took, to standard error."""

    def __init__(self, what):
        self.what, self.t = what, time.perf_counter()

    def __call__(self, stage):
        now = time.perf_counter()
        print(f"{self.what} set-up: {stage} {now - self.t:.3f} s",
              file=sys.stderr)
        self.t = now
