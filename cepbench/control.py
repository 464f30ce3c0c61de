"""The control of the check: the plain reference computed in bfloat16,
one precision below the float32 the configurations state, put in the
program's place and held to the float32 reference by the cell's own
comparison.  It has to come out as not correct.

    python3 cepbench/control.py --workload <cell> --batches <n> \\
        --seeds <s> [<s> ...]

``--batches``: as many as a run of the cell makes.  The references run
on the card where there is one, as a run's check does.  Prints one JSON
line a seed with the numbers the check compares.  The benchmark's
own runs never run it.
"""

import json
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from cepbench import harness  # noqa: E402
from cepbench.generator import Traffic  # noqa: E402


def readings(cell: "harness.Cell", seed: int, n_batches: int,
             device: str) -> dict:
    """The check's numbers for the control at one seed."""
    config = cell.config
    traffic = Traffic(cell.mix, seed)
    ref = harness.load_module("reference", config["reference"])
    want = ref.reference(config, traffic, n_batches, device)
    low = ref.reference(config, traffic, n_batches, device,
                        precision="bfloat16")
    got, program = ref.as_received(config, traffic, low)
    numbers = ref.compare(config, traffic, n_batches, want, got, program)
    numbers.pop("failed_batches")
    ok = all(o for _v, _lim, o in harness.held(ref, numbers).values())
    return {"workload": cell.name, "seed": seed, "batches": n_batches,
            "correct": ok, "checks": numbers}


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--batches", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = harness.Cell(args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.batches, device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
