"""GCS persistence: pluggable table store with an in-memory and a durable
file-backed flavor.

Role-equivalent of the reference's ``StoreClient`` abstraction
(``src/ray/gcs/store_client/``: ``InMemoryStoreClient``,
``RedisStoreClient``) that backs GCS fault tolerance — on restart the GCS
reloads all tables (``gcs_init_data.cc``) and resumes. The environment has
no Redis, so the durable flavor is an append-only journal with snapshot
compaction on open (same recovery semantics: replay-in-order, last write
wins).

Record format (journal): 4-byte big-endian length + wire-msgpack
``[op, table, key, value]`` record (typed schema, wire.py), fsync'd per batch. Corrupt/short tails
(crash mid-write) are truncated on load.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

from ray_tpu_torch._private import wire

logger = logging.getLogger("ray_tpu_torch.store")

_PUT, _DEL, _DEL_TABLE = 0, 1, 2


class StoreClient:
    """Synchronous table/key/value store. Values are opaque bytes."""

    def put(self, table: str, key: str, value: bytes) -> None:
        raise NotImplementedError

    def get(self, table: str, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def delete(self, table: str, key: str) -> None:
        raise NotImplementedError

    def delete_table(self, table: str) -> None:
        raise NotImplementedError

    def all(self, table: str) -> Dict[str, bytes]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class InMemoryStoreClient(StoreClient):
    def __init__(self):
        self._tables: Dict[str, Dict[str, bytes]] = {}

    def put(self, table, key, value):
        self._tables.setdefault(table, {})[key] = value

    def get(self, table, key):
        return self._tables.get(table, {}).get(key)

    def delete(self, table, key):
        self._tables.get(table, {}).pop(key, None)

    def delete_table(self, table):
        self._tables.pop(table, None)

    def all(self, table):
        return dict(self._tables.get(table, {}))


class FileStoreClient(StoreClient):
    """Append-only journal + snapshot compaction, crash-safe enough for the
    GCS restart path (tail truncation on partial writes)."""

    SNAPSHOT = "snapshot.db"
    JOURNAL = "journal.db"
    # first bytes of every journal; a journal without it (older/other
    # format) is preserved as .incompat and reported, never silently
    # truncated to nothing
    MAGIC = b"RTPUJ1\n"
    # compact when the journal holds this many records beyond the snapshot
    COMPACT_EVERY = 50_000

    # coalesce fsyncs: at most one per this interval (bounded-loss window —
    # the GCS state is also rebuilt from raylet heartbeats, so a few ms of
    # recent mutations is an acceptable crash window vs. stalling the
    # control-plane event loop on every record)
    FSYNC_INTERVAL_S = 0.01

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._tables: Dict[str, Dict[str, bytes]] = {}
        self._journal_records = 0
        self._last_fsync = 0.0
        self._load()
        jpath = os.path.join(self.dir, self.JOURNAL)
        fresh = not os.path.exists(jpath) or os.path.getsize(jpath) == 0
        self._journal = open(jpath, "ab")
        if fresh:
            self._journal.write(self.MAGIC)
            self._journal.flush()

    # -- recovery ------------------------------------------------------

    def _load(self):
        snap = os.path.join(self.dir, self.SNAPSHOT)
        if os.path.exists(snap):
            try:
                with open(snap, "rb") as f:
                    self._tables = wire.loads(f.read())
            except Exception:
                corrupt = snap + ".corrupt"
                logger.error(
                    "GCS snapshot %s is unreadable — starting from the journal "
                    "alone; most persisted state is LOST. Saved the bad file "
                    "as %s", snap, corrupt, exc_info=True)
                try:
                    os.replace(snap, corrupt)
                except OSError as e:
                    logger.debug("quarantine rename of %s failed: %s", snap, e)
                self._tables = {}
        for op, table, key, value in self._read_journal():
            self._apply(op, table, key, value)
            self._journal_records += 1

    def _read_journal(self) -> Iterable[Tuple[int, str, str, Optional[bytes]]]:
        path = os.path.join(self.dir, self.JOURNAL)
        if not os.path.exists(path):
            return
        good = 0
        with open(path, "rb") as f:
            head = f.read(len(self.MAGIC))
            if head != self.MAGIC:
                if head:  # non-empty journal in an unknown/older format
                    incompat = path + ".incompat"
                    logger.error(
                        "GCS journal %s lacks the %r header (older or "
                        "foreign format) — refusing to replay or truncate "
                        "it; saved as %s. Durable state from that journal "
                        "is NOT loaded.", path, self.MAGIC, incompat)
                    try:
                        os.replace(path, incompat)
                    except OSError as e:
                        logger.debug("quarantine rename of %s failed: %s",
                                     path, e)
                return
            good = f.tell()
            while True:
                header = f.read(4)
                if len(header) < 4:
                    break
                length = int.from_bytes(header, "big")
                body = f.read(length)
                if len(body) < length:
                    break
                try:
                    yield wire.loads(body)
                except Exception as e:
                    logger.debug("journal replay stopped at torn/corrupt "
                                 "record (offset %d): %s", good, e)
                    break
                good = f.tell()
        size = os.path.getsize(path)
        if good < size:  # torn tail from a crash mid-append
            with open(path, "r+b") as f:
                f.truncate(good)

    def _apply(self, op, table, key, value):
        if op == _PUT:
            self._tables.setdefault(table, {})[key] = value
        elif op == _DEL:
            self._tables.get(table, {}).pop(key, None)
        elif op == _DEL_TABLE:
            self._tables.pop(table, None)

    # -- journal -------------------------------------------------------

    def _append(self, op, table, key, value):
        body = wire.dumps([op, table, key, value])
        self._journal.write(len(body).to_bytes(4, "big") + body)
        self._journal.flush()
        now = time.monotonic()
        if now - self._last_fsync >= self.FSYNC_INTERVAL_S:
            os.fsync(self._journal.fileno())
            self._last_fsync = now
        # raylint: disable=RCE001 the other write site (_load) runs once inside __init__ before the server accepts connections — construction happens-before every locked _append
        self._journal_records += 1
        if self._journal_records >= self.COMPACT_EVERY:
            self._compact_locked()

    def _compact_locked(self):
        snap = os.path.join(self.dir, self.SNAPSHOT)
        tmp = snap + ".tmp"
        with open(tmp, "wb") as f:
            f.write(wire.dumps(self._tables))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, snap)
        self._journal.close()
        self._journal = open(os.path.join(self.dir, self.JOURNAL), "wb")
        self._journal.write(self.MAGIC)
        self._journal.flush()
        self._journal_records = 0

    # -- StoreClient ---------------------------------------------------

    def put(self, table, key, value):
        with self._lock:
            self._apply(_PUT, table, key, value)
            self._append(_PUT, table, key, value)

    def get(self, table, key):
        with self._lock:
            return self._tables.get(table, {}).get(key)

    def delete(self, table, key):
        with self._lock:
            self._apply(_DEL, table, key, None)
            self._append(_DEL, table, key, None)

    def delete_table(self, table):
        with self._lock:
            self._apply(_DEL_TABLE, table, "", None)
            self._append(_DEL_TABLE, table, "", None)

    def all(self, table):
        with self._lock:
            return dict(self._tables.get(table, {}))

    def close(self):
        with self._lock:
            try:
                self._journal.flush()
                os.fsync(self._journal.fileno())
                self._journal.close()
            except Exception as e:
                logger.debug("journal close failed: %s", e)


def make_store(persist_dir: str = "") -> StoreClient:
    return FileStoreClient(persist_dir) if persist_dir else InMemoryStoreClient()
