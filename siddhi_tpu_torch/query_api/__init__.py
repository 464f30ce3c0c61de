"""Query object model (AST/IR) for SiddhiQL.

Re-design of the reference L0 layer
(``modules/siddhi-query-api/src/main/java/io/siddhi/query/api/``,
SURVEY.md section 1, row L0).  Pure data: immutable-ish dataclasses that
the compiler produces and the planner consumes.  A copy of the JAX
package's ``query_api`` so the PyTorch port imports nothing of it.
"""

from siddhi_tpu_torch.query_api.attribute import Attribute, AttrType
from siddhi_tpu_torch.query_api.annotation import Annotation
from siddhi_tpu_torch.query_api.expression import (
    Expression,
    Constant,
    TimeConstant,
    Variable,
    FunctionCall,
    ArithmeticOp,
    CompareOp,
    AndOp,
    OrOp,
    NotOp,
    InOp,
    IsNull,
    IsNullStream,
)
from siddhi_tpu_torch.query_api.definition import (
    AbstractDefinition,
    StreamDefinition,
    TableDefinition,
    WindowDefinition,
    TriggerDefinition,
    FunctionDefinition,
    AggregationDefinition,
)
from siddhi_tpu_torch.query_api.execution import (
    InputStream,
    Query,
    Selector,
    OutputAttribute,
    OrderByAttribute,
    SingleInputStream,
    JoinInputStream,
    StateInputStream,
    StreamHandler,
    Filter,
    StreamFunction,
    WindowHandler,
    StateElement,
    StreamStateElement,
    AbsentStreamStateElement,
    CountStateElement,
    LogicalStateElement,
    NextStateElement,
    EveryStateElement,
    OutputStream,
    InsertIntoStream,
    ReturnStream,
    DeleteStream,
    UpdateStream,
    UpdateOrInsertStream,
    SetAttribute,
    OutputRate,
    EventOutputRate,
    TimeOutputRate,
    SnapshotOutputRate,
    Partition,
    PartitionType,
    ValuePartitionType,
    RangePartitionType,
    OnDemandQuery,
)
from siddhi_tpu_torch.query_api.app import SiddhiApp
