"""The control of a cell's comparison, and the program's readings beside
it, on several seeds in one process.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 --seconds <s>

Each seed is one run of the cell as ``run.py`` makes it (a shorter window
does: the comparison takes the same sample at its end), after which the
f32 reference judges both the program and the control: the reference
itself computed in fp8 (W8A8), the precision below the configuration's
bf16, put in the program's place at the same positions.  One JSON line a
seed: the program's readings and the control's.  A cell's limits lie
between the largest program reading and the smallest control reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    run.use_checkout_caches()
    import torch

    from pb import spec

    cell = spec.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("the control needs a CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run.serve(cell, seed, args.seconds, False, "cuda", time.perf_counter(), control=True)
        print(json.dumps({"seed": seed, "program": r["program"], "control": r["control"],
                          "correct": r["result"]["correct"], "check_s": r["check_s"]}), flush=True)
        del r
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
