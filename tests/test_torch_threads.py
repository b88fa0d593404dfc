"""One intra-op thread in each test process.

The suite runs under pytest-xdist, one process per worker, and torch's
default of one intra-op thread per core oversubscribes the cores several
times over: the port's tests run many small CPU operations, and each
spends its time in threads waiting for each other (measured on 8 cores
with 6 workers: the whole suite took 1664 s at the default and 267 s with
one thread, the same tests passing and failing).  Every worker imports
every test module while it collects, so setting the count here sets it
for the whole run.
"""
import torch

torch.set_num_threads(1)


def test_one_intra_op_thread_per_test_process():
    assert torch.get_num_threads() == 1
