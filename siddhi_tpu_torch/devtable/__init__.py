"""Device-resident tables: columnar device storage, scatter mutations,
snapshot-consistent stream-table joins.  Port of the JAX package's
``devtable/``.

Enabled per app by ``@app:devtables(capacity='N')`` under
``@app:execution('tpu')``.  Eligible tables build as ``DeviceTable``
(columnar ``[C]`` device tensors + validity lane + host slot map);
ineligible ones fall back to ``InMemoryTable`` — logged, never an error.
"""

from siddhi_tpu_torch.devtable.join import (
    DevTableJoinReceiver,
    DevTableJoinRuntime,
)
from siddhi_tpu_torch.devtable.planner import (
    plan_devtable_mutation,
    try_plan_devtable_join,
)
from siddhi_tpu_torch.devtable.storage import DeviceTable

__all__ = [
    "DeviceTable",
    "DevTableJoinReceiver",
    "DevTableJoinRuntime",
    "plan_devtable_mutation",
    "try_plan_devtable_join",
]
