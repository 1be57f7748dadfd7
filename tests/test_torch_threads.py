"""Torch's intra-op threads under pytest-xdist.

Each xdist worker is a process of its own, and torch gives each one as many
intra-op threads as the machine has cores: six workers on eight cores then
run 48 threads that take turns on the cores, and a torch-heavy test runs
many times slower than alone. pytest imports every test module in a worker
before its first test runs, so the setting below, made when this module is
imported, holds for every test of the worker: the cores are shared out
between the workers, two threads each at least. Not one: a CPU reduction
splits its work by the thread count, and at one thread the summation order
of the reduced ShuffleNetV2's GroupNorm gradients moves an element that
adam amplifies past ``test_torch_cnn.py::test_build_train_step_matches_jax``'s
bound (it holds at 2, 4 and 8). Outside xdist nothing changes.
"""
import os

import torch

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
_THREADS = max(2, (os.cpu_count() or 1) // int(_WORKERS)) if _WORKERS else None
if _THREADS:
    torch.set_num_threads(_THREADS)


def test_workers_share_the_cores():
    if _THREADS:
        assert torch.get_num_threads() == _THREADS
    else:
        assert torch.get_num_threads() >= 1
