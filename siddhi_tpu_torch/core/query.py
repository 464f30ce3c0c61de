"""Host query pieces: the expression environment and the filter.

Port of the part of the JAX package's ``core/query.py`` that the
aggregation runtime needs: ``build_env`` and ``FilterProcessor`` for
``from S[cond]`` aggregation inputs.  The query runtime and its selector
belong to the device-query slice of the port.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from siddhi_tpu_torch.core import event as ev
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.planner.host_expr import N_KEY, TS_KEY, CompiledExpression
from siddhi_tpu_torch.query_api import AttrType


def build_env(batch: EventBatch, key_map: Optional[Dict[str, str]] = None) -> Dict:
    """The expression environment of a batch: its columns, timestamps
    and length.  ``key_map`` maps env keys -> batch column names
    (identity when None)."""
    if key_map is None:
        env = dict(batch.columns)
    else:
        env = {k: batch.columns[v] for k, v in key_map.items()}
    env[TS_KEY] = batch.timestamps
    env[N_KEY] = len(batch)
    return env


class FilterProcessor:
    """Drops rows whose boolean condition is false
    (reference: query/processor/filter/FilterProcessor.java:32)."""

    def __init__(self, condition: CompiledExpression, key_map: Optional[Dict[str, str]] = None):
        if condition.type != AttrType.BOOL:
            raise SiddhiAppCreationError("filter condition must be boolean")
        self.condition = condition
        self.key_map = key_map

    def process(self, batch: EventBatch, now: int) -> EventBatch:
        if len(batch) == 0:
            return batch
        mask = np.broadcast_to(
            np.asarray(self.condition.fn(build_env(batch, self.key_map))), (len(batch),)
        )
        # control events (RESET/TIMER) always pass through
        keep = mask | (batch.types >= ev.TIMER)
        if keep.all():
            return batch
        return batch.mask(keep)
