"""Checkpoint capture: freeze state under the barrier.

Port of the JAX package's ``durability/capture.py``.  The persist path
calls :func:`freeze` on each element of the state tree under the
barrier:

* a ``torch.Tensor`` leaf is **cloned on its own device**.  The port's
  steps write their state in place (``dense_batch.cu``, the bank's
  ``accumulate_``, the general and timer steps), so a tensor kept by
  reference, as the reference keeps its immutable device arrays, would
  be overwritten by the next batch before the writer thread fetched it.
  The clone belongs to the capture; on a card a ``torch.cuda.Event`` is
  recorded after the clones and the writer waits on it before the
  fetch;
* numpy arrays and host containers (dicts, lists, ``EventBatch``,
  ``Event``) are copied, so later mutation cannot race the pickle;
* anything freeze does not understand makes that ELEMENT fall back to an
  in-barrier ``pickle.dumps`` (``prepickled``), counted through
  ``on_fallback`` — degradation, never corruption.

Materialization (the device-to-host fetch of the clones through
``util/faults.host_copy``, one ``fetch_coalesced`` an element) and
per-element pickling run in :meth:`StateCapture.materialize_blobs` on
the writer thread (or inline, for a synchronous persist).
"""

from __future__ import annotations

import pickle
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from siddhi_tpu_torch.core.event import Event, EventBatch
from siddhi_tpu_torch.util.faults import host_copy


class UnfreezableStateError(Exception):
    """An element's state holds a type freeze cannot safely copy."""


_SCALARS = (type(None), bool, int, float, complex, str, bytes)
_SCALAR_TYPES = frozenset(_SCALARS)


def freeze(obj: Any, devices: Optional[set] = None) -> Any:
    """Race-free copy of one element's snapshot state.

    ``devices`` collects the CUDA devices whose clones are in flight (the
    caller records one event on each).  Raises
    :class:`UnfreezableStateError` on any type whose aliasing semantics
    are unknown — the caller then pre-pickles that element under the
    barrier instead."""
    if isinstance(obj, _SCALARS) or isinstance(obj, np.generic):
        return obj
    if isinstance(obj, np.ndarray):
        return obj.copy()
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda and devices is not None:
            devices.add(obj.device)
        return obj.clone()
    if isinstance(obj, dict):
        # scalar values are taken as they are: a dense runtime's key map
        # holds a million of them
        return {k: v if type(v) in _SCALAR_TYPES else freeze(v, devices)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [v if type(v) in _SCALAR_TYPES else freeze(v, devices)
                for v in obj]
    if isinstance(obj, tuple):
        return tuple(freeze(v, devices) for v in obj)
    if isinstance(obj, (set, frozenset)):
        return set(obj) if isinstance(obj, set) else obj
    if isinstance(obj, deque):
        return deque((freeze(v, devices) for v in obj), maxlen=obj.maxlen)
    if isinstance(obj, EventBatch):
        out = EventBatch(
            obj.stream_id,
            list(obj.attribute_names),
            {k: freeze(v, devices) for k, v in obj.columns.items()},
            obj.timestamps.copy(),
            obj.types.copy(),
        )
        out.aux = {k: freeze(v, devices) for k, v in obj.aux.items()}
        return out
    if isinstance(obj, Event):
        return Event(obj.timestamp, [freeze(v, devices) for v in obj.data],
                     obj.is_expired)
    raise UnfreezableStateError(type(obj).__name__)


class CapturedElement:
    """One state-tree element: frozen state OR an in-barrier pickle."""

    __slots__ = ("kind", "name", "state", "prepickled")

    def __init__(self, kind: str, name: str, state: Any = None,
                 prepickled: Optional[bytes] = None):
        self.kind = kind
        self.name = name
        self.state = state
        self.prepickled = prepickled


class StateCapture:
    """Everything ``persist()`` collects under the barrier.

    ``elements`` keep the snapshot tree's (kind, name) addressing so the
    writer can emit per-element blobs (durable store) or reassemble the
    monolithic tree pickle (plain stores) — both restore through the
    unchanged ``SnapshotService.restore`` path.  ``ready`` holds the
    CUDA events recorded after the clones."""

    __slots__ = ("app", "version", "elements", "fallbacks", "ready")

    def __init__(self, app: str, version: int,
                 elements: List[CapturedElement],
                 fallbacks: List[Tuple[str, str]],
                 ready: Optional[List[Any]] = None):
        self.app = app
        self.version = version
        self.elements = elements
        # [(element key, reason)] for elements that took the in-barrier
        # pickle fallback
        self.fallbacks = fallbacks
        self.ready = ready or []

    def _wait_clones(self):
        """The clones were enqueued on the barrier thread's stream: wait
        for them before another thread reads their memory."""
        for ev in self.ready:
            ev.synchronize()
        self.ready = []

    def materialize_blobs(self) -> List[Tuple[str, str, bytes]]:
        """[(kind, name, pickled bytes)] — D2H fetch + pickle, off-barrier."""
        self._wait_clones()
        out: List[Tuple[str, str, bytes]] = []
        for el in self.elements:
            if el.prepickled is not None:
                out.append((el.kind, el.name, el.prepickled))
            else:
                out.append((el.kind, el.name, pickle.dumps(
                    host_copy(el.state),
                    protocol=pickle.HIGHEST_PROTOCOL)))
        return out

    def tree_bytes(self) -> bytes:
        """Monolithic tree pickle, bit-compatible with
        ``SnapshotService.full_snapshot`` (for stores without a
        per-element blob layout)."""
        return pickle.dumps(self.tree(), protocol=pickle.HIGHEST_PROTOCOL)

    def tree(self) -> Dict:
        self._wait_clones()
        tree: Dict = {"version": self.version, "app": self.app,
                      "queries": {}, "tables": {}, "named_windows": {},
                      "partitions": {}, "aggregations": {}}
        for el in self.elements:
            if el.prepickled is not None:
                tree[el.kind][el.name] = pickle.loads(el.prepickled)
            else:
                tree[el.kind][el.name] = host_copy(el.state)
        return tree


def capture_elements(app: str, version: int, tree: Dict,
                     element_kinds: Tuple[str, ...],
                     on_fallback: Optional[Callable[[str, str], None]] = None,
                     ) -> StateCapture:
    """Freeze a just-built state tree into a :class:`StateCapture`.

    Caller holds the barrier (process lock, emits drained).  An element
    freeze cannot copy is pickled here, in-barrier — the per-element
    sync degradation path — and reported through
    ``on_fallback(element_key, reason)``."""
    elements: List[CapturedElement] = []
    fallbacks: List[Tuple[str, str]] = []
    devices: set = set()
    for kind in element_kinds:
        for name, state in tree.get(kind, {}).items():
            try:
                elements.append(CapturedElement(
                    kind, name, state=freeze(state, devices)))
            except UnfreezableStateError as e:
                reason = f"unfreezable:{e}"
                fallbacks.append((f"{kind}:{name}", reason))
                if on_fallback is not None:
                    on_fallback(f"{kind}:{name}", reason)
                elements.append(CapturedElement(
                    kind, name,
                    prepickled=pickle.dumps(
                        host_copy(state), protocol=pickle.HIGHEST_PROTOCOL)))
    ready = []
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ready.append(ev)
    return StateCapture(app, version, elements, fallbacks, ready)
