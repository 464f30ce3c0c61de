"""Readout ``dense_overflow``: the dense pattern runtime's dropped
instances, per key, read once the run has drained (through
``pattern_runtimes()`` and the runtime's live snapshot; one small
device-to-host copy).  The check holds them to the reference's."""

import numpy as np


def read(rt, config: dict) -> dict:
    """``{"dropped": {key: count}}`` of every key with a drop, and
    ``"dropped_total"``, the runtime's whole counter."""
    (runtime,) = rt.pattern_runtimes().values()
    snap = runtime.snapshot(fetch=False)
    per_row = snap["dense_state"]["overflow"].cpu().numpy()
    rows = np.flatnonzero(per_row)
    key_of = {r: k for k, r in snap["key_rows"].items()}
    return {"dropped": {int(key_of[r]): int(per_row[r]) for r in rows
                        if r in key_of},
            "dropped_total": int(per_row.sum())}
