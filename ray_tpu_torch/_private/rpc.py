"""Asyncio RPC used by every control-plane and data-plane service.

Role-equivalent of the reference's gRPC wrappers (``src/ray/rpc``): a length-
prefixed msgpack envelope over TCP with request/response correlation,
automatic reconnect + retry with exponential backoff
(``retryable_grpc_client.h``), server->client push streams (used for pubsub,
like the reference's long-poll subscriber), and config-driven chaos injection
(``rpc/rpc_chaos.h``) so failure-handling paths are testable from day one.

Payloads are opaque bytes; control-plane callers encode them with the typed
wire schema (wire.py) — never pickle. Every frame carries the wire protocol
version; frames missing it or carrying a different version are rejected
before the payload is touched (reference: protobuf schema versioning in
``src/ray/protobuf/``).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import random
import time
from typing import Awaitable, Callable, Dict, Optional, Tuple

from ray_tpu_torch._private import msgpack

from ray_tpu_torch._private.async_util import spawn
from ray_tpu_torch._private.config import RAY_CONFIG
from ray_tpu_torch._private.wire import WIRE_VERSION

logger = logging.getLogger(__name__)

_REQUEST, _REPLY_OK, _REPLY_ERR, _PUSH, _NOTIFY = 0, 1, 2, 3, 4

_MAX_FRAME = 1 << 31


class RpcError(Exception):
    pass


class RpcVersionError(RpcError):
    """Peer spoke a missing or different wire protocol version."""


class RpcConnectionError(RpcError):
    pass


class RpcNotConnectedError(RpcConnectionError):
    """Raised before any bytes were sent — always safe to retry, even for
    non-idempotent calls (the server never saw the request)."""


class RpcApplicationError(RpcError):
    """Remote handler raised; message carries the remote traceback string."""


# ---------------------------------------------------------------------------
# Chaos injection (reference: src/ray/rpc/rpc_chaos.h:24-39)
# ---------------------------------------------------------------------------


class _ChaosState:
    def __init__(self, spec: Optional[str] = None):
        self._counts: Dict[str, int] = {}
        self._spec: Dict[str, Tuple[int, float]] = {}
        if spec is None:
            spec = RAY_CONFIG.testing_rpc_failure
        if spec:
            for entry in spec.split(","):
                method, _, rest = entry.partition("=")
                n, _, p = rest.partition(":")
                self._spec[method.strip()] = (int(n or 0), float(p or 0.0))

    def should_fail(self, method: str) -> bool:
        if not self._spec:
            return False
        if method not in self._spec:
            return False
        n, p = self._spec[method]
        seen = self._counts.get(method, 0)
        self._counts[method] = seen + 1
        if seen < n:
            return True
        return random.random() < p


async def _maybe_chaos(chaos: _ChaosState, method: str):
    delay_ms = RAY_CONFIG.testing_rpc_delay_ms
    if delay_ms:
        await asyncio.sleep(delay_ms / 1000.0)
    if chaos.should_fail(method):
        raise RpcConnectionError(f"chaos: injected failure for {method}")


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------


async def _read_frame(reader: asyncio.StreamReader):
    header = await reader.readexactly(4)
    length = int.from_bytes(header, "big")
    if length > _MAX_FRAME:
        raise RpcError(f"frame too large: {length}")
    body = await reader.readexactly(length)
    try:
        parts = msgpack.unpackb(body)
    except Exception as e:
        raise RpcVersionError(f"unparseable frame (not wire msgpack): {e}")
    if not isinstance(parts, list) or len(parts) != 5 or parts[0] != WIRE_VERSION:
        got = parts[0] if isinstance(parts, list) and parts else "<none>"
        raise RpcVersionError(
            f"frame wire version {got!r} != {WIRE_VERSION} — peer is "
            f"unversioned or from an incompatible release")
    return parts[1:]


def _write_frame(writer: asyncio.StreamWriter, parts) -> None:
    body = msgpack.packb([WIRE_VERSION, *parts])
    writer.write(len(body).to_bytes(4, "big") + body)


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

Handler = Callable[[str, bytes, "ServerConnection"], Awaitable[bytes]]


class ServerConnection:
    """One accepted client connection; supports server->client pushes."""

    _ids = itertools.count(1)

    def __init__(self, reader, writer):
        self.reader = reader
        self.writer = writer
        self.conn_id = next(self._ids)
        self.closed = asyncio.Event()
        self._send_lock = asyncio.Lock()
        self.peer = writer.get_extra_info("peername")

    async def push(self, channel: str, payload: bytes) -> bool:
        if self.closed.is_set():
            return False
        try:
            async with self._send_lock:
                _write_frame(self.writer, [0, _PUSH, channel, payload])
                await self.writer.drain()
            return True
        except (ConnectionError, RuntimeError, OSError):
            self.closed.set()
            return False

    async def reply(self, msg_id: int, kind: int, payload: bytes):
        async with self._send_lock:
            _write_frame(self.writer, [msg_id, kind, "", payload])
            await self.writer.drain()


class RpcServer:
    def __init__(self, handler: Handler, host: str = "127.0.0.1", port: int = 0):
        self._handler = handler
        self._host = host
        self._port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._chaos = _ChaosState()
        # reply-side chaos (reference rpc_chaos.h's reply-failure flavor):
        # the handler RUNS, then the connection drops before the reply —
        # produces zombie executions whose side effects raced a retry
        self._reply_chaos = _ChaosState(RAY_CONFIG.testing_rpc_reply_failure)
        self.connections: Dict[int, ServerConnection] = {}
        self.on_disconnect: Optional[Callable[[ServerConnection], Awaitable[None]]] = None

    @property
    def address(self) -> str:
        return f"{self._host}:{self._port}"

    async def start(self) -> str:
        self._server = await asyncio.start_server(self._on_client, self._host, self._port)
        self._port = self._server.sockets[0].getsockname()[1]
        return self.address

    async def stop(self):
        # close the live connections first: since Python 3.12 wait_closed()
        # waits for every connection to end, so a peer that stays connected
        # (a borrower's worker) would hold shutdown until the caller's
        # timeout (the JAX runtime's order, which does that)
        if self._server:
            self._server.close()
        for conn in list(self.connections.values()):
            try:
                conn.writer.close()
            except Exception as e:
                logger.debug("closing connection to %s failed: %s",
                             conn.peer, e)
        if self._server:
            try:
                await self._server.wait_closed()
            except Exception as e:
                logger.debug("server wait_closed failed: %s", e)

    async def _on_client(self, reader, writer):
        conn = ServerConnection(reader, writer)
        self.connections[conn.conn_id] = conn
        try:
            while True:
                msg_id, kind, method, payload = await _read_frame(reader)
                if kind == _NOTIFY:
                    spawn(self._dispatch(conn, None, method, payload),
                          what="rpc notify dispatch")
                elif kind == _REQUEST:
                    spawn(self._dispatch(conn, msg_id, method, payload),
                          what="rpc request dispatch")
        except RpcVersionError as e:
            logger.warning("dropping %s: %s", conn.peer, e)
        except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
            logger.debug("connection from %s closed: %s", conn.peer, e)
        finally:
            conn.closed.set()
            self.connections.pop(conn.conn_id, None)
            if self.on_disconnect is not None:
                try:
                    await self.on_disconnect(conn)
                except Exception:
                    logger.exception("on_disconnect handler failed")
            try:
                writer.close()
            except Exception as e:
                logger.debug("writer close for %s failed: %s", conn.peer, e)

    async def _dispatch(self, conn, msg_id, method, payload):
        try:
            await _maybe_chaos(self._chaos, method)
            result = await self._handler(method, payload, conn)
            if self._reply_chaos.should_fail(method):
                conn.writer.close()
                conn.closed.set()
                return
            if msg_id is not None:
                await conn.reply(msg_id, _REPLY_OK, result if result is not None else b"")
        except Exception as e:
            if msg_id is not None:
                import traceback

                err = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
                try:
                    await conn.reply(msg_id, _REPLY_ERR, err.encode())
                except Exception as e2:
                    logger.debug("error reply to %s undeliverable: %s",
                                 conn.peer, e2)
            else:
                logger.exception("error in one-way handler %s", method)


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class RpcClient:
    """Connection to one RpcServer; thread-compatible via the owning event loop."""

    def __init__(self, address: str, on_push: Optional[Callable] = None):
        self.address = address
        host, _, port = address.rpartition(":")
        self._host, self._port = host, int(port)
        self._reader = None
        self._writer = None
        self._msg_ids = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        self._on_push = on_push
        self._read_task = None
        self._lock = asyncio.Lock()
        self._closed = False
        self._chaos = _ChaosState()

    async def connect(self, timeout: Optional[float] = None):
        timeout = timeout or RAY_CONFIG.rpc_connect_timeout_s
        deadline = time.monotonic() + timeout
        delay = RAY_CONFIG.rpc_retry_base_delay_ms / 1000.0
        last = None
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                # bound each attempt too: a SYN blackhole (partitioned peer)
                # must not camp for the kernel retry timeout
                self._reader, self._writer = await asyncio.wait_for(
                    asyncio.open_connection(self._host, self._port), remaining
                )
                self._read_task = asyncio.ensure_future(self._read_loop())
                return self
            except asyncio.TimeoutError:
                last = TimeoutError(f"connect attempt timed out after {remaining:.1f}s")
            except OSError as e:
                last = e
                await asyncio.sleep(min(delay, max(0.0, deadline - time.monotonic())))
                delay = min(delay * 2, RAY_CONFIG.rpc_retry_max_delay_ms / 1000.0)
        raise RpcNotConnectedError(f"cannot connect to {self.address}: {last}")

    @property
    def connected(self) -> bool:
        return self._writer is not None and not self._closed

    async def _read_loop(self):
        try:
            while True:
                msg_id, kind, method, payload = await _read_frame(self._reader)
                if kind == _PUSH:
                    if self._on_push is not None:
                        try:
                            res = self._on_push(method, payload)
                            if asyncio.iscoroutine(res):
                                spawn(res, what="push handler")
                        except Exception:
                            logger.exception("push handler failed")
                elif kind in (_REPLY_OK, _REPLY_ERR):
                    fut = self._pending.pop(msg_id, None)
                    if fut is not None and not fut.done():
                        if kind == _REPLY_OK:
                            fut.set_result(payload)
                        else:
                            fut.set_exception(RpcApplicationError(payload.decode()))
        except RpcVersionError as e:
            self._fail_pending(e)
        except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
            self._fail_pending(RpcConnectionError(f"connection to {self.address} lost: {e}"))
        except asyncio.CancelledError:
            self._fail_pending(RpcConnectionError("client closed"))

    def _fail_pending(self, exc):
        self._closed = True
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(exc)
        self._pending.clear()

    async def call(self, method: str, payload: bytes = b"", timeout: Optional[float] = None) -> bytes:
        await _maybe_chaos(self._chaos, method)
        if not self.connected:
            raise RpcNotConnectedError(f"not connected to {self.address}")
        msg_id = next(self._msg_ids)
        fut = asyncio.get_event_loop().create_future()
        self._pending[msg_id] = fut
        try:
            async with self._lock:
                _write_frame(self._writer, [msg_id, _REQUEST, method, payload])
                await self._writer.drain()
        except (ConnectionError, OSError) as e:
            self._pending.pop(msg_id, None)
            raise RpcConnectionError(str(e))
        timeout = timeout if timeout is not None else RAY_CONFIG.rpc_call_timeout_s
        return await asyncio.wait_for(fut, timeout)

    async def notify(self, method: str, payload: bytes = b""):
        if not self.connected:
            raise RpcConnectionError(f"not connected to {self.address}")
        async with self._lock:
            _write_frame(self._writer, [0, _NOTIFY, method, payload])
            await self._writer.drain()

    async def close(self):
        self._closed = True
        if self._read_task:
            self._read_task.cancel()
        if self._writer:
            try:
                self._writer.close()
            except Exception as e:
                logger.debug("client writer close failed: %s", e)


class RetryingRpcClient:
    """Reconnects and retries idempotent calls (reference: retryable_grpc_client.h)."""

    def __init__(self, address: str, on_push: Optional[Callable] = None,
                 on_reconnect: Optional[Callable] = None):
        self.address = address
        self._on_push = on_push
        self._on_reconnect = on_reconnect
        self._client: Optional[RpcClient] = None
        self._connect_lock: Optional[asyncio.Lock] = None

    async def _ensure(self, connect_timeout: Optional[float] = None) -> RpcClient:
        if self._connect_lock is None:
            self._connect_lock = asyncio.Lock()
        async with self._connect_lock:
            if self._client is None or not self._client.connected:
                client = RpcClient(self.address, on_push=self._on_push)
                try:
                    await client.connect(timeout=connect_timeout)
                    if self._on_reconnect is not None:
                        res = self._on_reconnect(client)
                        if asyncio.iscoroutine(res):
                            await res
                except BaseException:
                    # don't cache a client whose post-connect setup (e.g. a
                    # pubsub re-Subscribe) didn't finish — a cancelled
                    # on_reconnect would otherwise be skipped forever
                    await client.close()
                    raise
                self._client = client
        return self._client

    async def call(self, method: str, payload: bytes = b"", timeout: Optional[float] = None,
                   retries: Optional[int] = None,
                   connect_timeout: Optional[float] = None,
                   presend_retries: Optional[int] = None) -> bytes:
        retries = RAY_CONFIG.rpc_max_retries if retries is None else retries
        if presend_retries is None:
            presend_retries = max(retries, 3)
        delay = RAY_CONFIG.rpc_retry_base_delay_ms / 1000.0
        attempt = 0
        presend_attempt = 0
        presend_deadline = None

        async def _connected_client() -> RpcClient:
            budget = connect_timeout
            if presend_deadline is not None:
                remaining = presend_deadline - time.monotonic()
                budget = remaining if budget is None else min(budget, remaining)
                if budget <= 0:
                    raise RpcNotConnectedError(
                        f"connect budget exhausted for {self.address}")
            if budget is None:
                return await self._ensure(None)
            try:
                # bound the whole ensure — including the wait on the shared
                # connect lock — so one slow caller can't inflate another
                # caller's fail-fast bound on the same cached client
                return await asyncio.wait_for(self._ensure(budget), budget)
            except asyncio.TimeoutError:
                raise RpcNotConnectedError(f"connect to {self.address} timed out")

        while True:
            try:
                client = await _connected_client()
                return await client.call(method, payload, timeout)
            except RpcNotConnectedError:
                # nothing was sent (connect failed, or the connection dropped
                # before the frame went out): reconnect and retry without
                # consuming the caller's retry budget — non-idempotent calls
                # stay safe. Deadline-bounded so a dead peer still fails fast.
                if presend_deadline is None:
                    presend_deadline = (
                        time.monotonic() + RAY_CONFIG.rpc_presend_retry_timeout_s)
                presend_attempt += 1
                if presend_attempt > presend_retries \
                        or time.monotonic() + delay >= presend_deadline:
                    raise
                await asyncio.sleep(delay)
                delay = min(delay * 2, RAY_CONFIG.rpc_retry_max_delay_ms / 1000.0)
            except (RpcConnectionError, asyncio.TimeoutError):
                attempt += 1
                if attempt > retries:
                    raise
                await asyncio.sleep(delay)
                delay = min(delay * 2, RAY_CONFIG.rpc_retry_max_delay_ms / 1000.0)

    async def notify(self, method: str, payload: bytes = b""):
        client = await self._ensure()
        await client.notify(method, payload)

    async def close(self):
        if self._client:
            await self._client.close()
