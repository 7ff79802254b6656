"""``python -m rot_mvgaze_tpu_torch --exp_name ... --mode train|test [--device cpu]``:
the port's command line (``cli/main.py``), the counterpart of the
repository's ``main.py``."""

import sys

from rot_mvgaze_tpu_torch import parallel
from rot_mvgaze_tpu_torch.cli.main import main

if __name__ == "__main__":
    try:
        code = main()
    finally:
        parallel.shutdown()  # leaves the process group torchrun's variables started
    sys.exit(code)
