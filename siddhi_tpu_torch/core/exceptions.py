"""Typed runtime exceptions (reference: io/siddhi/core/exception/*)."""


class SiddhiAppCreationError(Exception):
    """Raised when an app fails to plan/compile
    (reference: SiddhiAppCreationException)."""


class KernelUnavailableError(SiddhiAppCreationError):
    """A CUDA kernel does not build or launch on the card.  No fallback
    catches it: the port has no device formulation without its kernels,
    so an app that needs one fails to create."""


class DeviceUncompilableError(SiddhiAppCreationError):
    """The device expression compiler refuses a node that the host
    compiler takes (``is null``, a function call): the dense engine
    defers it to its plan-time trace, where the reference's step fails
    on the same filter."""


class SiddhiAppRuntimeError(Exception):
    """Raised for failures while processing events
    (reference: SiddhiAppRuntimeException)."""


class DefinitionNotExistError(SiddhiAppCreationError):
    """Unknown stream/table/window referenced
    (reference: DefinitionNotExistException)."""


class StoreQueryCreationError(Exception):
    """On-demand query failed to plan
    (reference: OnDemandQueryCreationException)."""


class CannotRestoreSiddhiAppStateError(Exception):
    """Snapshot restore failed
    (reference: CannotRestoreSiddhiAppStateException)."""


class ConnectionUnavailableError(Exception):
    """Source/Sink transport connection failure; triggers backoff retry
    (reference: ConnectionUnavailableException)."""


class InjectedFaultError(SiddhiAppRuntimeError):
    """Deterministic fault raised by the fault-injection harness
    (util/faults.py) at a runtime choke point.  No reference analog:
    the project's chaos-testing surface."""


class TransferFaultError(InjectedFaultError):
    """Transient device<->host transfer failure (injected, or classed
    retryable by a hook).  The async emit pipeline retries these with
    bounded backoff before routing to the fault handler."""


class DeviceLostError(InjectedFaultError):
    """Sticky device loss: NOT retryable — every transfer against the
    lost device fails until the runtime is restored onto a healthy
    one."""


class SimulatedCrashError(BaseException):
    """Injected process crash.  Deliberately a BaseException: it must
    tear through every ``except Exception`` recovery layer exactly as a
    SIGKILL would, so crash-recovery tests exercise the real
    restore-and-replay path rather than some hardened catch site."""


class OnErrorAction:
    """@OnError(action=...) values (reference: StreamJunction.OnErrorAction)."""

    LOG = "log"
    STREAM = "stream"
    STORE = "store"


class SiddhiParserException(SiddhiAppCreationError):
    """Alias space for compiler errors surfaced through app creation."""


class NoSuchAttributeError(SiddhiAppCreationError):
    """Attribute not found on a definition
    (reference: NoSuchAttributeException)."""


class QueryNotExistError(SiddhiAppRuntimeError):
    """Unknown query name (reference: QueryNotExistException)."""


class OperationNotSupportedError(SiddhiAppRuntimeError):
    """Operation not valid for the target element
    (reference: OperationNotSupportedException)."""


class OnDemandQueryRuntimeError(SiddhiAppRuntimeError):
    """On-demand query failed during execution
    (reference: OnDemandQueryRuntimeException)."""


class NoPersistenceStoreError(SiddhiAppRuntimeError):
    """persist() without a configured store
    (reference: NoPersistenceStoreException)."""


class PersistenceStoreError(SiddhiAppRuntimeError):
    """Store-level save/load failure
    (reference: PersistenceStoreException)."""


class CannotClearSiddhiAppStateError(SiddhiAppRuntimeError):
    """Revision cleanup failed
    (reference: CannotClearSiddhiAppStateException)."""


class DataPurgingError(SiddhiAppRuntimeError):
    """Incremental-aggregation purge failure
    (reference: DataPurgingException)."""


class QueryableRecordTableError(SiddhiAppRuntimeError):
    """Store-side query compilation/execution failure
    (reference: QueryableRecordTableException)."""


class CannotLoadConfigurationError(SiddhiAppCreationError):
    """Config plane failure (reference: CannotLoadConfigurationException,
    YAMLConfigManagerException)."""


class SiddhiAppValidationError(SiddhiAppCreationError):
    """Plan-time validation failure — bad extension arguments, invalid
    definitions (reference: SiddhiAppValidationException)."""


# Java-style aliases (the reference's exact names, for drop-in familiarity)
SiddhiAppCreationException = SiddhiAppCreationError
SiddhiAppValidationException = SiddhiAppValidationError
SiddhiAppRuntimeException = SiddhiAppRuntimeError
OnDemandQueryCreationException = StoreQueryCreationError
StoreQueryCreationException = StoreQueryCreationError
CannotRestoreSiddhiAppStateException = CannotRestoreSiddhiAppStateError
ConnectionUnavailableException = ConnectionUnavailableError
DefinitionNotExistException = DefinitionNotExistError


def later_slice(item: int, what: str) -> str:
    """The tail of a refusal: the ``ROADMAP.md`` §1 item that ports what
    was refused."""
    return f" — ROADMAP.md §1 item {item} ({what}), a later slice of the port"
