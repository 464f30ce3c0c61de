"""Tables: in-memory (``table.py``), store-backed record tables
(``record.py``) and the output callbacks that write them
(``callbacks.py``).  Port of the JAX package's ``table/``."""

from siddhi_tpu_torch.table.table import (
    CompiledTableCondition,
    InMemoryTable,
    compile_table_condition,
)
from siddhi_tpu_torch.table.record import (
    AbstractRecordTable,
    InMemoryRecordStore,
    RecordCompiledCondition,
    RecordTableHandler,
    RecordTableRuntime,
    TableCache,
)
from siddhi_tpu_torch.table.callbacks import (
    DeleteTableCallback,
    InsertIntoTableCallback,
    UpdateOrInsertTableCallback,
    UpdateTableCallback,
    compile_set_clause,
)

__all__ = [
    "AbstractRecordTable",
    "CompiledTableCondition",
    "InMemoryRecordStore",
    "RecordCompiledCondition",
    "RecordTableHandler",
    "RecordTableRuntime",
    "TableCache",
    "compile_table_condition",
    "InMemoryTable",
    "DeleteTableCallback",
    "InsertIntoTableCallback",
    "UpdateOrInsertTableCallback",
    "UpdateTableCallback",
    "compile_set_clause",
]
