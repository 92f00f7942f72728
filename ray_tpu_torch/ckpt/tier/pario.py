"""ParallelIO: the per-host bounded thread-pool chunk transfer engine. The
port of ``ray_tpu/ckpt/tier/pario.py``.

Both directions of cross-tier traffic go through one engine per host:

- **fetch**: N worker threads pull full chunks concurrently, every byte
  sha256-verified against its content address before it is handed to the
  caller (a remote tier returning corrupt bytes is *rejected*, never
  silently restored). A failed/corrupt chunk does not poison the batch —
  the caller gets the partial result plus per-chunk errors and decides
  (the tiered store falls back to the local tier per chunk);
- **put**: uploads ride the same pool; ``put`` returning ``created=False``
  is the dedup hit that makes re-mirroring idempotent and delta saves
  upload only changed bytes;
- **in-flight byte cap**: per-host admission control — a worker blocks
  while admitting its chunk would push in-flight bytes over the cap
  (one oversized chunk is always admitted alone, so progress is
  guaranteed). Restore on a 96-host mesh must not buffer an unbounded
  slice of the checkpoint in RAM per host;
- **range coalescing**: ``read_ranges`` merges byte ranges whose gap is
  under ``ckpt_io_coalesce_gap`` into single ranged GETs — many small
  box-intersection reads against one chunk become few object-store
  round-trips.

Metrics ride the port's registry under the JAX package's names,
``ray_tpu.ckpt.tier.*``.
"""

from __future__ import annotations

import hashlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.ckpt.tier.backend import ChunkBackend

_metrics_lock = threading.Lock()
_metrics: Optional[dict] = None


def _obs() -> dict:
    """Lazily-created tier metrics on the shared registry."""
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            from ray_tpu_torch.util.metrics import Counter, Histogram

            _metrics = {
                "fetch_bytes": Counter(
                    "ray_tpu.ckpt.tier.fetch_bytes",
                    "chunk bytes fetched from a non-local tier"),
                "fetch_chunks": Counter(
                    "ray_tpu.ckpt.tier.fetch_chunks",
                    "chunks fetched from a non-local tier"),
                "upload_bytes": Counter(
                    "ray_tpu.ckpt.tier.upload_bytes",
                    "chunk bytes uploaded to a non-local tier"),
                "upload_chunks": Counter(
                    "ray_tpu.ckpt.tier.upload_chunks",
                    "chunks uploaded to a non-local tier"),
                "dedup_bytes": Counter(
                    "ray_tpu.ckpt.tier.dedup_bytes",
                    "upload bytes skipped because the tier already held "
                    "the content address"),
                "verify_failures": Counter(
                    "ray_tpu.ckpt.tier.verify_failures",
                    "cross-tier reads rejected by sha256 verification"),
                "inflight_wait_seconds": Histogram(
                    "ray_tpu.ckpt.tier.inflight_wait_seconds",
                    "time transfers waited on the per-host in-flight "
                    "byte cap",
                    boundaries=[0.001, 0.01, 0.1, 1, 10]),
            }
        return _metrics


class ChunkVerifyError(RuntimeError):
    """A cross-tier read returned bytes whose sha256 does not match the
    chunk's content address."""

    def __init__(self, h: str, got: str):
        super().__init__(f"chunk {h[:12]}… failed sha256 verification "
                         f"(tier returned content {got[:12]}…)")
        self.chunk = h
        self.got = got


class ChunkFetchError(RuntimeError):
    """One or more chunks of a parallel fetch failed. ``partial`` holds
    every chunk that DID arrive (verified); ``errors`` maps the failed
    hashes to their exceptions — callers fall back per chunk."""

    def __init__(self, errors: Dict[str, BaseException],
                 partial: Dict[str, bytes]):
        super().__init__(
            f"{len(errors)} of {len(errors) + len(partial)} chunk fetches "
            f"failed: {sorted(errors)[:3]}…")
        self.errors = errors
        self.partial = partial


class _ByteGate:
    """Admission control: at most ``cap`` payload bytes in flight. An
    oversized request is admitted only when nothing else is in flight."""

    def __init__(self, cap: int):
        self.cap = int(cap)
        self._inflight = 0
        self._cv = threading.Condition()

    def acquire(self, nbytes: int) -> float:
        import time

        t0 = time.monotonic()
        with self._cv:
            while self._inflight and self._inflight + nbytes > self.cap:
                self._cv.wait()
            self._inflight += nbytes
        return time.monotonic() - t0

    def release(self, nbytes: int) -> None:
        with self._cv:
            self._inflight -= nbytes
            self._cv.notify_all()


def coalesce_ranges(ranges: List[Tuple[int, int]],
                    gap: int) -> List[Tuple[int, int]]:
    """Merge ``(offset, length)`` ranges separated by at most ``gap``
    bytes into covering ranges (reading a small gap is cheaper than a
    second round-trip). Input need not be sorted; output is. Zero-length
    ranges drop, so ranges that are all empty give ``[]`` (the JAX copy
    raises ``IndexError`` there)."""
    spans = sorted((off, off + ln) for off, ln in ranges if ln > 0)
    if not spans:
        return []
    out: List[Tuple[int, int]] = []
    cur_s, cur_e = spans[0]
    for s, e in spans[1:]:
        if s - cur_e <= gap:
            cur_e = max(cur_e, e)
        else:
            out.append((cur_s, cur_e - cur_s))
            cur_s, cur_e = s, e
    out.append((cur_s, cur_e - cur_s))
    return out


class ParallelIO:
    """Bounded-parallel chunk transfer against one backend."""

    def __init__(self, backend: ChunkBackend, *,
                 threads: Optional[int] = None,
                 inflight_bytes: Optional[int] = None,
                 coalesce_gap: Optional[int] = None,
                 verify: bool = True):
        from ray_tpu_torch._private.config import RAY_CONFIG

        self.backend = backend
        self.threads = max(1, int(threads if threads is not None
                                  else RAY_CONFIG.ckpt_io_threads))
        self._gate = _ByteGate(
            inflight_bytes if inflight_bytes is not None
            else RAY_CONFIG.ckpt_io_inflight_bytes)
        self.coalesce_gap = int(coalesce_gap if coalesce_gap is not None
                                else RAY_CONFIG.ckpt_io_coalesce_gap)
        self.verify = verify
        self.counters: Dict[str, int] = {}
        self._lock = threading.Lock()

    def _count(self, **kv: int) -> None:
        with self._lock:
            for k, v in kv.items():
                self.counters[k] = self.counters.get(k, 0) + v

    def _pool(self) -> ThreadPoolExecutor:
        return ThreadPoolExecutor(max_workers=self.threads,
                                  thread_name_prefix="ckpt-tier-io")

    # -- fetch ---------------------------------------------------------

    def _fetch_one(self, h: str, nbytes: int) -> bytes:
        wait = self._gate.acquire(max(nbytes, 1))
        try:
            if wait > 0.001:
                _obs()["inflight_wait_seconds"].observe(wait)
            data = self.backend.get(h)
            if self.verify:
                got = hashlib.sha256(data).hexdigest()
                if got != h:
                    _obs()["verify_failures"].inc(1)
                    self._count(verify_failures=1)
                    raise ChunkVerifyError(h, got)
            _obs()["fetch_bytes"].inc(len(data))
            _obs()["fetch_chunks"].inc(1)
            self._count(fetch_chunks=1, fetch_bytes=len(data))
            return data
        finally:
            self._gate.release(max(nbytes, 1))

    def fetch(self, sizes: Dict[str, int]) -> Dict[str, bytes]:
        """Fetch every chunk of ``{hash: expected_nbytes}`` concurrently,
        verified. Raises :class:`ChunkFetchError` carrying the verified
        partial result if any chunk fails."""
        if not sizes:
            return {}
        results: Dict[str, bytes] = {}
        errors: Dict[str, BaseException] = {}
        with self._pool() as pool:
            futs = {h: pool.submit(self._fetch_one, h, n)
                    for h, n in sizes.items()}
            for h, fut in futs.items():
                try:
                    results[h] = fut.result()
                except BaseException as e:
                    errors[h] = e
        if errors:
            raise ChunkFetchError(errors, results)
        return results

    def read_ranges(self, h: str, ranges: List[Tuple[int, int]],
                    ) -> List[bytes]:
        """Ranged reads of one chunk, coalesced (gap ≤ ``coalesce_gap``)
        into covering GETs and sliced back out. NOT content-verified —
        a partial read cannot be hashed against the chunk address; use
        :meth:`fetch` when crossing a tier you do not trust."""
        merged = coalesce_ranges(ranges, self.coalesce_gap)
        blocks: Dict[Tuple[int, int], bytes] = {}

        def _read(span: Tuple[int, int]) -> None:
            off, ln = span
            blocks[span] = self.backend.get(h, offset=off, length=ln)
            self._count(ranged_gets=1, ranged_bytes=ln)

        with self._pool() as pool:
            list(pool.map(_read, merged))
        out: List[bytes] = []
        for off, ln in ranges:
            for (m_off, m_ln), data in blocks.items():
                if m_off <= off and off + ln <= m_off + m_ln:
                    out.append(data[off - m_off:off - m_off + ln])
                    break
            else:
                raise AssertionError("range not covered by coalesced read")
        return out

    # -- put -----------------------------------------------------------

    def _put_one(self, h: str, data, nbytes: int) -> Tuple[bool, int]:
        wait = self._gate.acquire(max(nbytes, 1))
        try:
            if wait > 0.001:
                _obs()["inflight_wait_seconds"].observe(wait)
            if callable(data):
                # lazy loader: bytes materialize only once admitted by
                # the gate, so a big mirror never holds the whole
                # checkpoint in RAM
                data = data()
            created = self.backend.put(h, data)
            if created:
                _obs()["upload_bytes"].inc(len(data))
                _obs()["upload_chunks"].inc(1)
                self._count(upload_chunks=1, upload_bytes=len(data))
            else:
                _obs()["dedup_bytes"].inc(len(data))
                self._count(dedup_chunks=1, dedup_bytes=len(data))
            return created, len(data)
        finally:
            self._gate.release(max(nbytes, 1))

    def put_many(self, chunks: Dict[str, object],
                 sizes: Optional[Dict[str, int]] = None) -> Dict[str, int]:
        """Upload chunks concurrently (idempotent by content address).
        Values are bytes or zero-arg loaders returning bytes (``sizes``
        supplies expected byte counts for gating when loaders are used).
        Returns this call's counters: uploaded/deduped chunks and bytes.
        Raises the first backend error AFTER every in-flight worker has
        settled (no torn pool state; re-running is safe)."""
        out = {"upload_chunks": 0, "upload_bytes": 0,
               "dedup_chunks": 0, "dedup_bytes": 0}
        if not chunks:
            return out
        sizes = sizes or {}
        first_error: List[BaseException] = []
        with self._pool() as pool:
            futs = {h: pool.submit(
                self._put_one, h, data,
                sizes.get(h, len(data) if isinstance(data, bytes) else 1))
                for h, data in chunks.items()}
            for h, fut in futs.items():
                try:
                    created, n = fut.result()
                except BaseException as e:
                    if not first_error:
                        first_error.append(e)
                    continue
                if created:
                    out["upload_chunks"] += 1
                    out["upload_bytes"] += n
                else:
                    out["dedup_chunks"] += 1
                    out["dedup_bytes"] += n
        if first_error:
            raise first_error[0]
        return out
