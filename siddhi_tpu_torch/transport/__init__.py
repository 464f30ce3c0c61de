"""Sources, sinks, their mappers, handlers and the in-memory broker
(port of the JAX package's ``transport/``)."""

from siddhi_tpu_torch.transport.broker import InMemoryBroker
from siddhi_tpu_torch.transport.source import (
    InMemorySource,
    PassThroughSourceMapper,
    JsonSourceMapper,
    Source,
    SourceMapper,
)
from siddhi_tpu_torch.transport.sink import (
    InMemorySink,
    JsonSinkMapper,
    LogSink,
    PassThroughSinkMapper,
    Sink,
    SinkMapper,
)

__all__ = [
    "InMemoryBroker",
    "InMemorySource",
    "InMemorySink",
    "JsonSinkMapper",
    "JsonSourceMapper",
    "LogSink",
    "PassThroughSinkMapper",
    "PassThroughSourceMapper",
    "Sink",
    "SinkMapper",
    "Source",
    "SourceMapper",
]
