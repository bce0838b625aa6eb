"""One intra-op thread for torch in every test process of the port.

Imported by every `tests/test_torch_*.py` file. Under pytest-xdist each
worker collects every file, so each worker imports torch; at torch's
default of one intra-op thread per core, six workers on an eight-core host
run up to 48 busy threads and every file, the reference's too, waits for
cores. The port's parity shapes are small, so one thread per worker is
the faster setting. Sizes and tolerances do not change.
"""

import torch

torch.set_num_threads(1)
