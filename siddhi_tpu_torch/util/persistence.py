"""Persistence stores: where serialized app snapshots live.

Port of the JAX package's ``util/persistence.py`` (host code, copied:
the port imports nothing of that package), itself a re-design of the
reference ``util/persistence/``
(InMemoryPersistenceStore.java, FileSystemPersistenceStore.java,
PersistenceHelper.java): a store maps (app name, revision) -> bytes,
where revision = ``<epoch_ms>_<app name>`` so lexicographic-by-timestamp
ordering gives the latest revision.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional, Tuple

log = logging.getLogger("siddhi_tpu_torch.persistence")


def fsync_dir(path: str):
    """fsync a directory so a just-renamed/created entry survives power
    loss (best effort: some filesystems refuse directory fds)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError as e:  # pragma: no cover - fs-dependent
        log.debug("persistence: directory fsync of %s failed: %s", path, e)
    finally:
        os.close(fd)


class FileJournalSegmentMixin:
    """Journal spill segments for filesystem-backed stores: one file per
    segment under ``<base>/<app>/journal/<seq0>_<seq1>.seg`` (the dir
    name carries no ``_``/revision prefix, so revision listings skip
    it).  Requires ``self._app_dir`` and ``self._lock``."""

    _JOURNAL_DIR = "journal"

    def _journal_dir(self, app_name: str) -> str:
        return os.path.join(self._app_dir(app_name), self._JOURNAL_DIR)

    @staticmethod
    def _seg_name(seq0: int, seq1: int) -> str:
        return f"{seq0:012d}-{seq1:012d}.seg"

    def save_journal_segment(self, app_name: str, seq0: int, seq1: int,
                             payload: bytes):
        with self._lock:
            d = self._journal_dir(app_name)
            os.makedirs(d, exist_ok=True)
            name = self._seg_name(seq0, seq1)
            tmp = os.path.join(d, name + ".tmp")
            with open(tmp, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(d, name))
            fsync_dir(d)

    def _segments(self, app_name: str) -> List[Tuple[int, int, str]]:
        d = self._journal_dir(app_name)
        try:
            names = os.listdir(d)
        except OSError:
            return []
        out = []
        for f in names:
            if not f.endswith(".seg"):
                continue
            try:
                seq0, seq1 = f[:-4].split("-", 1)
                out.append((int(seq0), int(seq1), f))
            except ValueError:
                log.warning("persistence: skipping foreign journal "
                            "segment %r in %s", f, d)
        return sorted(out)

    def load_journal_segments(
            self, app_name: str) -> List[Tuple[int, int, bytes]]:
        with self._lock:
            out = []
            d = self._journal_dir(app_name)
            for seq0, seq1, fname in self._segments(app_name):
                with open(os.path.join(d, fname), "rb") as f:
                    out.append((seq0, seq1, f.read()))
            return out

    def prune_journal_segments(self, app_name: str, upto_seq: int):
        """Remove segments fully covered by a committed checkpoint."""
        with self._lock:
            d = self._journal_dir(app_name)
            for _seq0, seq1, fname in self._segments(app_name):
                if seq1 <= upto_seq:
                    try:
                        os.remove(os.path.join(d, fname))
                    except OSError:
                        pass

    def clear_journal(self, app_name: str):
        with self._lock:
            d = self._journal_dir(app_name)
            for _seq0, _seq1, fname in self._segments(app_name):
                try:
                    os.remove(os.path.join(d, fname))
                except OSError:
                    pass


class PersistenceStore:
    """SPI: save / load / last revision / clear for one app's snapshots."""

    def save(self, app_name: str, revision: str, snapshot: bytes):
        raise NotImplementedError

    def load(self, app_name: str, revision: str) -> Optional[bytes]:
        raise NotImplementedError

    def get_last_revision(self, app_name: str) -> Optional[str]:
        raise NotImplementedError

    def revisions(self, app_name: str) -> List[str]:
        """All revisions, oldest first.  Default falls back to the last
        revision only; concrete stores override with the full list so
        restore can walk backwards past a corrupted newest revision."""
        last = self.get_last_revision(app_name)
        return [last] if last else []

    def clear_all_revisions(self, app_name: str):
        raise NotImplementedError


class InMemoryPersistenceStore(PersistenceStore):
    """Keeps revisions in a process-local dict (reference:
    InMemoryPersistenceStore.java).  Bounded: only the newest
    ``revisions_to_keep`` survive, so periodic persistence cannot grow
    the process without limit (parity with the filesystem store)."""

    def __init__(self, revisions_to_keep: int = 10):
        self.revisions_to_keep = revisions_to_keep
        self._store: Dict[str, Dict[str, bytes]] = {}
        # journal spill segments: app -> {(seq0, seq1): payload}
        self._journal: Dict[str, Dict[Tuple[int, int], bytes]] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _rev_key(revision: str):
        """Order by the leading timestamp of ``<ts>_<app>`` revision ids
        (SnapshotService.new_revision); foreign ids sort lexically."""
        head = revision.split("_", 1)[0]
        return (0, int(head), "") if head.isdigit() else (1, 0, revision)

    def save(self, app_name: str, revision: str, snapshot: bytes):
        with self._lock:
            revs = self._store.setdefault(app_name, {})
            revs[revision] = snapshot
            for old in sorted(revs, key=self._rev_key
                              )[: max(0, len(revs) - self.revisions_to_keep)]:
                del revs[old]

    def load(self, app_name: str, revision: str) -> Optional[bytes]:
        with self._lock:
            return self._store.get(app_name, {}).get(revision)

    def get_last_revision(self, app_name: str) -> Optional[str]:
        with self._lock:
            revs = self._store.get(app_name)
            if not revs:
                return None
            return max(revs, key=self._rev_key)

    def revisions(self, app_name: str) -> List[str]:
        with self._lock:
            revs = self._store.get(app_name, {})
            return sorted(revs, key=self._rev_key)

    def clear_all_revisions(self, app_name: str):
        with self._lock:
            self._store.pop(app_name, None)

    # -- journal spill segments (durability/spill.py) -----------------

    def save_journal_segment(self, app_name: str, seq0: int, seq1: int,
                             payload: bytes):
        with self._lock:
            self._journal.setdefault(app_name, {})[(seq0, seq1)] = payload

    def load_journal_segments(
            self, app_name: str) -> List[Tuple[int, int, bytes]]:
        with self._lock:
            segs = self._journal.get(app_name, {})
            return [(s0, s1, segs[(s0, s1)]) for s0, s1 in sorted(segs)]

    def prune_journal_segments(self, app_name: str, upto_seq: int):
        with self._lock:
            segs = self._journal.get(app_name, {})
            for key in [k for k in segs if k[1] <= upto_seq]:
                del segs[key]

    def clear_journal(self, app_name: str):
        with self._lock:
            self._journal.pop(app_name, None)


class FileSystemPersistenceStore(FileJournalSegmentMixin, PersistenceStore):
    """One file per revision under ``<base>/<app>/<revision>``
    (reference: FileSystemPersistenceStore.java).  Keeps the newest
    ``revisions_to_keep`` files (reference default 3)."""

    def __init__(self, base_dir: str, revisions_to_keep: int = 3):
        self.base_dir = base_dir
        self.revisions_to_keep = revisions_to_keep
        self._lock = threading.Lock()

    def _app_dir(self, app_name: str) -> str:
        return os.path.join(self.base_dir, app_name)

    def _revisions(self, app_name: str) -> List[str]:
        d = self._app_dir(app_name)
        try:
            names = os.listdir(d)
        except OSError:
            # missing or concurrently-deleted app dir: no revisions
            return []
        # .tmp files are crash leftovers from an interrupted save;
        # names without a valid <epoch_ms>_ prefix are foreign junk
        revs = []
        for f in names:
            if "_" not in f or f.endswith(".tmp"):
                continue
            try:
                int(f.split("_", 1)[0])
            except ValueError:
                log.warning("persistence: skipping foreign file %r in %s",
                            f, d)
                continue
            revs.append(f)
        return sorted(revs, key=lambda r: int(r.split("_", 1)[0]))

    def save(self, app_name: str, revision: str, snapshot: bytes):
        with self._lock:
            d = self._app_dir(app_name)
            os.makedirs(d, exist_ok=True)
            tmp = os.path.join(d, revision + ".tmp")
            # fsync before the rename and fsync the dir after: without
            # both, a power loss can leave a "committed" revision empty
            # (rename durable, data not) or missing (rename not durable)
            with open(tmp, "wb") as f:
                f.write(snapshot)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(d, revision))
            fsync_dir(d)
            # evict oldest beyond the keep count
            revs = self._revisions(app_name)
            for old in revs[: max(0, len(revs) - self.revisions_to_keep)]:
                try:
                    os.remove(os.path.join(d, old))
                except OSError:
                    pass

    def load(self, app_name: str, revision: str) -> Optional[bytes]:
        path = os.path.join(self._app_dir(app_name), revision)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as e:
            # missing file OR app dir deleted between listing and read
            log.warning("persistence: cannot read revision %r of app "
                        "%r (%s); skipping", revision, app_name, e)
            return None
        if not data:
            # zero-length file: a save truncated by a crash before any
            # bytes landed — treat as absent, restore falls back
            log.warning("persistence: revision %r of app %r is empty "
                        "(truncated save?); skipping", revision, app_name)
            return None
        return data

    def get_last_revision(self, app_name: str) -> Optional[str]:
        with self._lock:
            revs = self._revisions(app_name)
            return revs[-1] if revs else None

    def revisions(self, app_name: str) -> List[str]:
        with self._lock:
            return self._revisions(app_name)

    def clear_all_revisions(self, app_name: str):
        with self._lock:
            d = self._app_dir(app_name)
            try:
                names = os.listdir(d)
            except OSError:
                return  # already gone (or never created)
            for f in names:
                try:
                    os.remove(os.path.join(d, f))
                except OSError:
                    # concurrently deleted: the goal state is reached
                    pass


class IncrementalPersistenceStore:
    """SPI for base+increment persistence (reference:
    util/persistence/IncrementalPersistenceStore.java): revisions carry a
    kind ('base' | 'inc'); restore needs the newest base plus every
    increment after it, in order."""

    def save(self, app_name: str, revision: str, kind: str, data: bytes):
        raise NotImplementedError

    def load_chain(self, app_name: str, until_revision: Optional[str] = None):
        """-> (base_revision, base_bytes, [(inc_revision, inc_bytes), ...])
        or None when no base exists.  With ``until_revision``, the chain
        stops at that revision (newest base at or before it plus the
        increments between)."""
        raise NotImplementedError

    def get_last_revision(self, app_name: str) -> Optional[str]:
        raise NotImplementedError

    def clear_all_revisions(self, app_name: str):
        raise NotImplementedError


class IncrementalFileSystemPersistenceStore(IncrementalPersistenceStore):
    """``<base>/<app>/<revision>.base|.inc`` files (reference:
    IncrementalFileSystemPersistenceStore.java).  Old bases and their
    increment chains are pruned, keeping ``bases_to_keep`` chains."""

    def __init__(self, base_dir: str, bases_to_keep: int = 2):
        self.base_dir = base_dir
        self.bases_to_keep = bases_to_keep
        self._lock = threading.Lock()

    def _app_dir(self, app_name: str) -> str:
        return os.path.join(self.base_dir, app_name)

    def _entries(self, app_name: str) -> List[tuple]:
        """[(ts, revision, kind)] sorted by timestamp."""
        d = self._app_dir(app_name)
        try:
            names = os.listdir(d)
        except OSError:
            return []
        out = []
        for f in names:
            if f.endswith(".tmp"):
                continue
            if f.endswith(".base") or f.endswith(".inc"):
                rev, kind = f.rsplit(".", 1)
                try:
                    ts = int(rev.split("_", 1)[0])
                except ValueError:
                    continue
                out.append((ts, rev, kind))
        return sorted(out)

    def save(self, app_name: str, revision: str, kind: str, data: bytes):
        assert kind in ("base", "inc")
        with self._lock:
            d = self._app_dir(app_name)
            os.makedirs(d, exist_ok=True)
            tmp = os.path.join(d, f"{revision}.{kind}.tmp")
            # same crash-consistency contract as the full store: data
            # durable before the rename, rename durable via dir fsync
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(d, f"{revision}.{kind}"))
            fsync_dir(d)
            if kind == "base":
                self._prune(app_name)

    def _prune(self, app_name: str):
        entries = self._entries(app_name)
        base_ts = [ts for ts, _, kind in entries if kind == "base"]
        if len(base_ts) <= self.bases_to_keep:
            return
        cutoff = sorted(base_ts)[-self.bases_to_keep]
        d = self._app_dir(app_name)
        for ts, rev, kind in entries:
            if ts < cutoff:
                try:
                    os.remove(os.path.join(d, f"{rev}.{kind}"))
                except OSError:
                    pass

    def load_chain(self, app_name: str, until_revision: Optional[str] = None):
        with self._lock:
            entries = self._entries(app_name)
            if until_revision is not None:
                try:
                    limit = int(until_revision.split("_", 1)[0])
                except ValueError:
                    return None
                entries = [e for e in entries if e[0] <= limit]
            bases = [(ts, rev) for ts, rev, kind in entries if kind == "base"]
            if not bases:
                return None
            base_ts, base_rev = bases[-1]
            d = self._app_dir(app_name)
            with open(os.path.join(d, f"{base_rev}.base"), "rb") as f:
                base_bytes = f.read()
            incs = []
            for ts, rev, kind in entries:
                if kind == "inc" and ts > base_ts:
                    with open(os.path.join(d, f"{rev}.inc"), "rb") as f:
                        incs.append((rev, f.read()))
            return base_rev, base_bytes, incs

    def get_last_revision(self, app_name: str) -> Optional[str]:
        with self._lock:
            entries = self._entries(app_name)
            return entries[-1][1] if entries else None

    def clear_all_revisions(self, app_name: str):
        with self._lock:
            d = self._app_dir(app_name)
            try:
                names = os.listdir(d)
            except OSError:
                return  # already gone (or never created)
            for f in names:
                try:
                    os.remove(os.path.join(d, f))
                except OSError:
                    pass
