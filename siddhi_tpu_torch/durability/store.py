"""Durable persistence store: blob-per-element + checksummed manifest.

Port of the JAX package's ``durability/store.py``.

Revision layout (under ``<base>/<app>/``)::

    <revision>.ckpt/
        0000.blob ... NNNN.blob     per-element pickles, fsynced
        MANIFEST.json               committed LAST: tmp + fsync + rename

The manifest carries a SHA-256 per blob plus a self-checksum over its
canonical JSON, so ``load`` detects torn blobs, bit flips, and partial
manifests — a revision without a valid manifest simply does not exist
(``revisions()`` skips it) and ``restore_last_revision()`` walks back to
the previous one.  Crash at ANY point mid-save therefore leaves either
the previous or the new revision fully restorable.

``save_tree`` threads an optional ``checker(site)`` callable (the fault
injector's ``check``) through the commit sequence so the crash-point
matrix can kill the writer between every durability step:
``persist.post_blob`` / ``persist.pre_manifest`` / ``persist.mid_manifest``
(tmp manifest durable, rename pending).

Journal spill segments live beside the revisions under
``<base>/<app>/journal/`` (util/persistence.py FileJournalSegmentMixin).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import shutil
import threading
from typing import Callable, Dict, List, Optional, Tuple

from siddhi_tpu_torch.util.persistence import (
    FileJournalSegmentMixin,
    PersistenceStore,
    fsync_dir,
)

log = logging.getLogger("siddhi_tpu_torch.durability")

MANIFEST_NAME = "MANIFEST.json"
MANIFEST_FORMAT = 1
_SUFFIX = ".ckpt"
# monolithic fallback: PersistenceStore.save bytes wrapped as one blob
_TREE_KIND = "__tree__"


def _manifest_checksum(manifest: Dict) -> str:
    body = {k: v for k, v in manifest.items() if k != "checksum"}
    canon = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode("utf-8")).hexdigest()


class DurableFileSystemPersistenceStore(FileJournalSegmentMixin,
                                        PersistenceStore):
    """Crash-consistent filesystem store (one directory per revision)."""

    def __init__(self, base_dir: str, revisions_to_keep: int = 3):
        self.base_dir = base_dir
        self.revisions_to_keep = revisions_to_keep
        self._lock = threading.Lock()

    def _app_dir(self, app_name: str) -> str:
        return os.path.join(self.base_dir, app_name)

    def _rev_dir(self, app_name: str, revision: str) -> str:
        return os.path.join(self._app_dir(app_name), revision + _SUFFIX)

    # -- save ---------------------------------------------------------------

    def save_tree(self, app_name: str, revision: str,
                  blobs: List[Tuple[str, str, bytes]],
                  checker: Optional[Callable[[str], None]] = None,
                  version: int = 1):
        """Write per-element ``blobs`` [(kind, name, bytes)] and commit
        the revision by atomically publishing its manifest.  Idempotent:
        a retry after a partial failure overwrites and re-commits."""
        with self._lock:
            rev_dir = self._rev_dir(app_name, revision)
            os.makedirs(rev_dir, exist_ok=True)
            elements = []
            for idx, (kind, name, data) in enumerate(blobs):
                fname = f"{idx:04d}.blob"
                path = os.path.join(rev_dir, fname)
                with open(path, "wb") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
                elements.append({
                    "kind": kind, "name": name, "file": fname,
                    "sha256": hashlib.sha256(data).hexdigest(),
                    "size": len(data),
                })
            if checker is not None:
                checker("persist.post_blob")
            manifest = {"format": MANIFEST_FORMAT, "app": app_name,
                        "revision": revision, "version": version,
                        "elements": elements}
            manifest["checksum"] = _manifest_checksum(manifest)
            if checker is not None:
                checker("persist.pre_manifest")
            tmp = os.path.join(rev_dir, MANIFEST_NAME + ".tmp")
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if checker is not None:
                # tmp manifest durable, rename pending: the one crash
                # point where the revision exists but is not committed
                checker("persist.mid_manifest")
            os.replace(tmp, os.path.join(rev_dir, MANIFEST_NAME))
            fsync_dir(rev_dir)
            fsync_dir(self._app_dir(app_name))
            self._evict_locked(app_name)

    def save(self, app_name: str, revision: str, snapshot: bytes):
        """PersistenceStore SPI: monolithic bytes become one blob."""
        self.save_tree(app_name, revision,
                       [(_TREE_KIND, _TREE_KIND, snapshot)])

    def _evict_locked(self, app_name: str):
        committed = self._committed_locked(app_name)
        app_dir = self._app_dir(app_name)
        for old in committed[: max(0, len(committed)
                                   - self.revisions_to_keep)]:
            shutil.rmtree(self._rev_dir(app_name, old), ignore_errors=True)
        # garbage-collect torn dirs (no valid manifest) older than the
        # newest committed revision — crash leftovers, never restorable
        if not committed:
            return
        newest_ts = int(committed[-1].split("_", 1)[0])
        try:
            names = os.listdir(app_dir)
        except OSError:
            return
        live = {r + _SUFFIX for r in committed}
        for d in names:
            if not d.endswith(_SUFFIX) or d in live:
                continue
            rev = d[: -len(_SUFFIX)]
            try:
                ts = int(rev.split("_", 1)[0])
            except ValueError:
                continue
            if ts < newest_ts:
                log.warning("durability: removing torn revision %r of "
                            "app %r (no valid manifest)", rev, app_name)
                shutil.rmtree(os.path.join(app_dir, d), ignore_errors=True)

    # -- load ---------------------------------------------------------------

    def _read_manifest(self, app_name: str, revision: str) -> Optional[Dict]:
        path = os.path.join(self._rev_dir(app_name, revision), MANIFEST_NAME)
        try:
            with open(path, "r", encoding="utf-8") as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            log.warning("durability: revision %r of app %r has no "
                        "readable manifest (%s)", revision, app_name, e)
            return None
        if manifest.get("checksum") != _manifest_checksum(manifest):
            log.warning("durability: manifest checksum mismatch on "
                        "revision %r of app %r", revision, app_name)
            return None
        return manifest

    def _read_blobs(self, app_name: str,
                    revision: str) -> Optional[List[Tuple[str, str, bytes]]]:
        manifest = self._read_manifest(app_name, revision)
        if manifest is None:
            return None
        rev_dir = self._rev_dir(app_name, revision)
        out = []
        for el in manifest.get("elements", []):
            try:
                with open(os.path.join(rev_dir, el["file"]), "rb") as f:
                    data = f.read()
            except OSError as e:
                log.warning("durability: blob %r missing from revision "
                            "%r of app %r (%s)", el.get("file"), revision,
                            app_name, e)
                return None
            if hashlib.sha256(data).hexdigest() != el.get("sha256"):
                log.warning("durability: blob %r of revision %r of app "
                            "%r fails its checksum", el.get("file"),
                            revision, app_name)
                return None
            out.append((el["kind"], el["name"], data))
        return out

    def load(self, app_name: str, revision: str) -> Optional[bytes]:
        """Checksum-validated revision bytes, reassembled into the
        monolithic tree pickle ``SnapshotService.restore`` expects.
        ``None`` on any corruption — the restore walk falls back."""
        blobs = self._read_blobs(app_name, revision)
        if blobs is None:
            return None
        if len(blobs) == 1 and blobs[0][0] == _TREE_KIND:
            return blobs[0][2]
        tree: Dict = {"queries": {}, "tables": {}, "named_windows": {},
                      "partitions": {}, "aggregations": {}}
        try:
            for kind, name, data in blobs:
                tree[kind][name] = pickle.loads(data)
        except Exception as e:
            log.warning("durability: revision %r of app %r holds an "
                        "unreadable element (%s)", revision, app_name, e)
            return None
        manifest = self._read_manifest(app_name, revision)
        tree["version"] = manifest.get("version", 1) if manifest else 1
        tree["app"] = app_name
        return pickle.dumps(tree, protocol=pickle.HIGHEST_PROTOCOL)

    # -- revisions ----------------------------------------------------------

    def _committed_locked(self, app_name: str) -> List[str]:
        """Revisions with a manifest file present, oldest first (manifest
        VALIDITY is checked at load; presence defines existence)."""
        d = self._app_dir(app_name)
        try:
            names = os.listdir(d)
        except OSError:
            return []
        revs = []
        for f in names:
            if not f.endswith(_SUFFIX):
                continue
            rev = f[: -len(_SUFFIX)]
            try:
                int(rev.split("_", 1)[0])
            except ValueError:
                continue
            if os.path.isfile(os.path.join(d, f, MANIFEST_NAME)):
                revs.append(rev)
        return sorted(revs, key=lambda r: int(r.split("_", 1)[0]))

    def get_last_revision(self, app_name: str) -> Optional[str]:
        with self._lock:
            revs = self._committed_locked(app_name)
            return revs[-1] if revs else None

    def revisions(self, app_name: str) -> List[str]:
        with self._lock:
            return self._committed_locked(app_name)

    def clear_all_revisions(self, app_name: str):
        with self._lock:
            d = self._app_dir(app_name)
            try:
                names = os.listdir(d)
            except OSError:
                return
            for f in names:
                if f.endswith(_SUFFIX):
                    shutil.rmtree(os.path.join(d, f), ignore_errors=True)
