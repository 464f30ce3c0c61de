"""Small sizes of the cells for runs on the CPU: the same app, traffic
kinds and checks, few partitions and short batches."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL = {
    "fraud16_1m.uniform": {
        "config": {"sizes": {"partitions": 256}},
        "traffic": {"batch": 256, "columns": {"key": {"modulo": 256}}}},
    "fraud16_1m.hot100k": {
        "config": {"sizes": {"partitions": 256}},
        "traffic": {"batch": 512, "columns": {"key": {"high": 64}}}},
}


def small_cell(name: str):
    from cepbench import harness

    return harness.Cell(name, overrides=SMALL[name])
