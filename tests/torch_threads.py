"""One intra-op thread for torch in every test process that imports it.

Every `tests/test_torch_*.py` imports this module before torch does any
work, and every pytest-xdist worker collects every test file, so the
setting holds for the whole worker (the JAX package's files that call
torch included), and for a file run on its own. Two reasons the tests
cannot show:

* the tier-1 command (ROADMAP.md) runs 6 xdist workers. On a machine of
  8 cores, with torch's default pool (a thread a core) in each worker,
  the workers' OpenMP threads spin against each other: six concurrent
  copies of `test_torch_port_graphs.py` finished 12 of their 26 tests in
  170 s, where with one thread each they finished all 26 in 16 s, and
  the port's files under the tier-1 flags summed 4,129 s of test time at
  the default against 234 s with one thread (about 25 times slower);
* the bit-equal checks (K steps in one call against K single calls, a
  replayed graph against eager calls) compare two runs of one summation
  order, which threaded CPU reductions do not keep from run to run.

Not a test module: its name does not start with `test_`.
"""

import torch

torch.set_num_threads(1)
