"""Run one cell of the benchmark on the card and print its result line.

    python3 cepbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Exits 2 without a result where no CUDA card (or too few) is present.
"""

import sys
import time

_T_PROCESS = time.perf_counter()

from pathlib import Path  # noqa: E402

# the checkout's root, in place of this directory, heads the path
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from cepbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_process=_T_PROCESS))
