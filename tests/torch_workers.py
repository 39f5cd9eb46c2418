"""One intra-op thread per pytest-xdist worker for the `test_torch_*` files.

The suite runs as six xdist workers; a torch CPU pool of a thread per core
in each of them oversubscribes the cores, and torch's CPU ops then slow by
an order of magnitude or more (a 13 s file took 790 s). Imported by every
port test file that runs torch ops on the CPU; a run without xdist keeps
torch's default pool."""
import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)
