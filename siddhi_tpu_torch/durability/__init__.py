"""Crash-consistent asynchronous durability pipeline.

Port of the JAX package's ``durability/`` (no analog in the reference
engine, whose persistence is a synchronous stop-the-world snapshot +
unchecked store write).  This package makes
``persist()`` cheap enough to take continuously and crash-safe at every
intermediate step:

``capture.py``   in-barrier state capture: device clones of tensors +
                 cheap host copies (freeze), with a counted per-element
                 pickle fallback for unfreezable state.
``writer.py``    background checkpoint writer: single-in-flight with
                 coalescing backpressure, retry-with-backoff on store
                 faults, crash containment.
``store.py``     ``DurableFileSystemPersistenceStore``: per-element blob
                 files + a checksummed manifest committed last via
                 fsync + atomic rename; journal-segment storage.
``spill.py``     journal overflow spill: cold input-journal segments
                 move to the persistence store instead of being dropped.
"""

from siddhi_tpu_torch.durability.capture import StateCapture, UnfreezableStateError, freeze
from siddhi_tpu_torch.durability.spill import JournalSpillSink
from siddhi_tpu_torch.durability.store import DurableFileSystemPersistenceStore
from siddhi_tpu_torch.durability.writer import AsyncCheckpointWriter, DurabilityStats

__all__ = [
    "AsyncCheckpointWriter",
    "DurabilityStats",
    "DurableFileSystemPersistenceStore",
    "JournalSpillSink",
    "StateCapture",
    "UnfreezableStateError",
    "freeze",
]
