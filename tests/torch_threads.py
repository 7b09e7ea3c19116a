"""Torch's intra-op threads for the port's CPU tests.

Every test module of the port imports this module first. When the test
files run in parallel worker processes (pytest-xdist), torch's default of
one intra-op thread per core puts workers x cores threads on the cores,
and the port's many small CPU ops wait on each other's spinning threads:
a test of 0.8 s alone took over a minute in such a run. So under xdist
each worker takes its share of the cores (at least one thread); a run in
one process keeps torch's default. The thread count changes no test's
inputs, cases or tolerances.
"""
import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))
