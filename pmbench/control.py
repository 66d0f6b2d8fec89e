"""A cell's correctness check on several seeds in one process: its control,
the cell's runs with the plain reference answering in the program's place
one precision below the configuration's (the placement scores in float32
where float64 is stated; the abundance EM in bfloat16 where float32 is),
each of which has to come out not correct; or, with --sound, the program's
own runs, whose readings set a limit's lower end.

  python3 pmbench/control.py --workload <cell> --seconds <s> [--sound] --seeds <n>...

Prints one JSON line a seed: the compared numbers and their limits, and
what the checks counted.  The benchmark's own runs never run it.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if __name__ == "__main__":
    import argparse

    from pmbench import harness, manifest

    ap = argparse.ArgumentParser(prog="pmbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sound", action="store_true")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    harness.set_cache_env()
    cell = manifest.cell(manifest.load(), args.workload)
    device = harness.card(cell.chips)
    if device is None:
        sys.exit(2)
    for seed in args.seeds:
        res = harness.run(cell, seed, args.seconds, False, device,
                          os.path.join(harness.workdir(args.workload),
                                       str(seed)),
                          time.perf_counter(), control=not args.sound)
        print(json.dumps({"seed": seed, "control": not args.sound,
                          "correct": harness.result_line(
                              cell, res, False, device)["correct"],
                          "samples": res["n"],
                          "checks": {n: [v, lim]
                                     for n, v, lim in res["checks"]},
                          "info": res["info"]}), flush=True)
