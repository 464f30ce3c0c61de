"""Snapshot service: full and incremental app state capture/restore.

Port of the JAX package's ``util/snapshot.py``, a re-design of the
reference ``util/snapshot/SnapshotService.java:90``: the
reference quiesces event threads with a ThreadBarrier, walks every
registered StateHolder keyed partitionId -> query -> element ->
(partitionKey x groupByKey), and Java-serializes the map.  Here the
quiesce point is the app's process lock (micro-batches are atomic under
it), the walk covers queries / tables / named windows / partitions /
aggregations, and serialization is pickle (numpy arrays and host dicts
round-trip losslessly).  The trees are the JAX package's: a revision
either package writes restores in the other.

``full_snapshot`` fetches device state inside each element's
``snapshot()``; ``capture`` (the persist path) takes the device
runtimes' state tensors as they are and ``durability/capture.freeze``
clones them on the device under the barrier, so the device-to-host
fetch runs after it.
"""

from __future__ import annotations

import hashlib
import pickle
import time
from typing import Dict, List, Tuple

from siddhi_tpu_torch.core.exceptions import CannotRestoreSiddhiAppStateError
from siddhi_tpu_torch.devtable import DeviceTable


SNAPSHOT_FORMAT_VERSION = 1


class SnapshotService:
    """Captures and restores the full state tree of one SiddhiAppRuntime."""

    def __init__(self, app_runtime):
        self.app = app_runtime
        # incremental mode: per-element digests since the last base
        self._digests: Dict[Tuple[str, str], str] = {}
        self._incs_since_base = 0

    # -- capture ------------------------------------------------------------

    def _state_tree(self, fetch: bool = True) -> Dict:
        """The app's state tree; ``fetch=False`` leaves the device
        runtimes' state as tensors (the capture clones them)."""
        tree: Dict = {
                "version": SNAPSHOT_FORMAT_VERSION,
                "app": self.app.name,
                "queries": {},
                "tables": {},
                "named_windows": {},
                "partitions": {},
                "aggregations": {},
            }
        for qname, qr in self.app.query_runtimes.items():
            if hasattr(qr, "snapshot_state"):
                tree["queries"][qname] = qr.snapshot_state(fetch=fetch)
        for tname, t in self.app.tables.items():
            # a device table's pinned revision stays on the device when
            # the capture clones it
            tree["tables"][tname] = (t.snapshot(fetch=fetch)
                                     if isinstance(t, DeviceTable)
                                     else t.snapshot())
        for wname, w in self.app.named_windows.items():
            tree["named_windows"][wname] = w.snapshot()
        for pname, p in self.app.partitions.items():
            tree["partitions"][pname] = p.snapshot(fetch=fetch)
        for aname, a in self.app.aggregations.items():
            tree["aggregations"][aname] = a.snapshot()
        return tree

    def full_snapshot(self) -> bytes:
        with self.app.app_context.process_lock:
            return pickle.dumps(self._state_tree(), protocol=pickle.HIGHEST_PROTOCOL)

    def capture(self, on_fallback=None):
        """Capture for the persist path (durability/capture.py): under
        the lock, freeze each element — device clones of the state
        tensors + cheap host copies — instead of pickling the whole
        tree.  Elements freeze cannot copy are pickled here (in-barrier)
        and reported via ``on_fallback``.  Returns a ``StateCapture``;
        the device-to-host fetch and serialization run on the
        checkpoint writer thread (or after the barrier, for a
        synchronous persist)."""
        from siddhi_tpu_torch.durability.capture import capture_elements

        with self.app.app_context.process_lock:
            tree = self._state_tree(fetch=False)
            return capture_elements(self.app.name, SNAPSHOT_FORMAT_VERSION,
                                    tree, self._ELEMENT_KINDS,
                                    on_fallback=on_fallback)

    # -- incremental capture -------------------------------------------------

    _ELEMENT_KINDS = ("queries", "tables", "named_windows", "partitions", "aggregations")

    def incremental_snapshot(self, base_interval: int = 10) -> Tuple[str, bytes]:
        """Capture state at changed-element granularity (re-design of the
        reference BASE/INCREMENT split, SnapshotService.java:186 +
        IncrementalSnapshot.java: the reference logs per-queue operations;
        here each element whose serialized state digest changed since the
        last base/increment is shipped whole — elements are the unit of
        incrementality).

        Returns ``(kind, bytes)`` with kind 'base' (full tree) or 'inc'
        (changed elements only).  A base is emitted on the first call and
        every ``base_interval`` increments."""
        with self.app.app_context.process_lock:
            tree = self._state_tree()
            blobs: Dict[Tuple[str, str], bytes] = {}
            digests: Dict[Tuple[str, str], str] = {}
            for kind in self._ELEMENT_KINDS:
                for name, state in tree[kind].items():
                    b = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
                    blobs[(kind, name)] = b
                    digests[(kind, name)] = hashlib.sha1(b).hexdigest()
            make_base = (
                not self._digests
                or self._incs_since_base + 1 >= base_interval
            )
            if make_base:
                self._digests = digests
                self._incs_since_base = 0
                return "base", pickle.dumps(tree, protocol=pickle.HIGHEST_PROTOCOL)
            changed = {
                key: blobs[key]
                for key, dg in digests.items()
                if self._digests.get(key) != dg
            }
            self._digests = digests
            self._incs_since_base += 1
            inc = {
                "version": SNAPSHOT_FORMAT_VERSION,
                "app": self.app.name,
                "elements": changed,
            }
            return "inc", pickle.dumps(inc, protocol=pickle.HIGHEST_PROTOCOL)

    def restore_incremental(self, base: bytes, increments: List[bytes]):
        """Restore a base snapshot overlaid with increments (in order)."""
        try:
            tree = pickle.loads(base)
        except Exception as e:
            raise CannotRestoreSiddhiAppStateError(
                f"app '{self.app.name}': base snapshot is unreadable: {e}"
            ) from e
        for raw in increments:
            try:
                inc = pickle.loads(raw)
            except Exception as e:
                raise CannotRestoreSiddhiAppStateError(
                    f"app '{self.app.name}': increment is unreadable: {e}"
                ) from e
            for (kind, name), blob in inc.get("elements", {}).items():
                tree[kind][name] = pickle.loads(blob)
        self.restore(pickle.dumps(tree, protocol=pickle.HIGHEST_PROTOCOL))

    # -- restore ------------------------------------------------------------

    def restore(self, snapshot: bytes):
        try:
            tree = pickle.loads(snapshot)
        except Exception as e:
            raise CannotRestoreSiddhiAppStateError(
                f"app '{self.app.name}': snapshot is unreadable: {e}"
            ) from e
        if tree.get("version") != SNAPSHOT_FORMAT_VERSION:
            raise CannotRestoreSiddhiAppStateError(
                f"app '{self.app.name}': snapshot format "
                f"{tree.get('version')!r} != {SNAPSHOT_FORMAT_VERSION}"
            )
        with self.app.app_context.process_lock:
            try:
                for qname, qs in tree["queries"].items():
                    qr = self.app.query_runtimes.get(qname)
                    if qr is not None and hasattr(qr, "restore_state"):
                        qr.restore_state(qs)
                for tname, ts in tree["tables"].items():
                    t = self.app.tables.get(tname)
                    if t is not None:
                        t.restore(ts)
                for wname, ws in tree["named_windows"].items():
                    w = self.app.named_windows.get(wname)
                    if w is not None:
                        w.restore(ws)
                for pname, ps in tree["partitions"].items():
                    p = self.app.partitions.get(pname)
                    if p is not None:
                        p.restore(ps)
                for aname, as_ in tree["aggregations"].items():
                    a = self.app.aggregations.get(aname)
                    if a is not None:
                        a.restore(as_)
            except CannotRestoreSiddhiAppStateError:
                raise
            except Exception as e:
                raise CannotRestoreSiddhiAppStateError(
                    f"app '{self.app.name}': state restore failed: {e}"
                ) from e
            finally:
                # a restore invalidates the incremental digest cache: an
                # 'inc' diffed against PRE-restore digests would corrupt
                # the chain on replay — force the next snapshot to a base
                self._digests = {}
                self._incs_since_base = 0

    # -- revisions ----------------------------------------------------------

    _rev_lock = __import__("threading").Lock()
    _last_rev_ts = 0

    @classmethod
    def new_revision(cls, app_name: str) -> str:
        """Monotonic per-process revision ids: two persists in the same
        millisecond must not collide (file names and the base/increment
        ordering are keyed by this timestamp)."""
        with cls._rev_lock:
            ts = max(int(time.time() * 1000), cls._last_rev_ts + 1)
            cls._last_rev_ts = ts
        return f"{ts}_{app_name}"
