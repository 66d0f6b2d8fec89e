"""panmap_tpu_torch's benchmark: one run of one cell.

  python3 pmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the checkout's root on a machine with the cell's NVIDIA cards.
The last line of standard output is the run's JSON result; without a card
the run exits 2 and prints none.  Build and kernel caches stay inside the
checkout (pmbench/.cache/), data and outputs under $TMPDIR/pmbench/.
"""

import os
import sys
import time

T_START = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if __name__ == "__main__":
    from pmbench import harness

    sys.exit(harness.main(sys.argv[1:], T_START))
