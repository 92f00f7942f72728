"""Client-mode proxy server (the ``ray-tpu://`` endpoint).

Reference: python/ray/util/client (ARCHITECTURE.md) — a gRPC proxy inside
the cluster executes the remote-API operations on behalf of thin external
clients. Here the proxy embeds a driver CoreWorker; each client
connection gets its own object/actor namespace maps, torn down on
disconnect (like the reference's per-client server data servicer).

Start in-cluster with ``start_client_server(port)`` (or
``ray-tpu start --client-server-port N``); connect from anywhere with
``ray_tpu_torch.init(address="ray-tpu://host:port")``.

The port of ``ray_tpu/util/client/server.py``. Functions, classes and values
cross in the port's pickler (``_private/serialization.py``: by value where
they cannot be imported by name, tensors as tensors), not ``cloudpickle``.
"""

from __future__ import annotations

import asyncio
import pickle
from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch._private.async_util import spawn
from ray_tpu_torch._private.rpc import RpcServer
from ray_tpu_torch._private.serialization import dumps, loads_trusted


class _ClientSession:
    """Per-session state, keyed by a CLIENT-GENERATED id so a transient
    reconnect resumes the same refs/handles (reference: client id channel
    metadata in util/client)."""

    def __init__(self):
        self.refs: Dict[bytes, Any] = {}        # client ref id -> ObjectRef
        self.actors: Dict[bytes, Any] = {}      # actor id -> ActorHandle
        self.owned_actors: Dict[bytes, Any] = {}  # created, non-detached
        self.functions: Dict[str, Any] = {}     # fn hash -> RemoteFunction
        self.classes: Dict[str, Any] = {}       # cls hash -> ActorClass
        self.conn_ids: set = set()


# grace before a disconnected session's resources are reaped (a reconnect
# within the window resumes it)
_REAP_GRACE_S = 60.0


class ClientProxyServer:
    def __init__(self, host: str = "0.0.0.0", port: int = 10001):
        from concurrent.futures import ThreadPoolExecutor

        self.server = RpcServer(self._handle, host, port)
        self.server.on_disconnect = self._on_disconnect
        self.sessions: Dict[str, _ClientSession] = {}
        self._conn_session: Dict[int, str] = {}
        # long-blocking gets/waits each park a thread: give them their own
        # wide pool so they can't starve other clients' traffic
        self._pool = ThreadPoolExecutor(max_workers=256,
                                        thread_name_prefix="client-proxy")

    async def start(self) -> str:
        return await self.server.start()

    async def stop(self):
        await self.server.stop()

    def _session(self, conn, req) -> _ClientSession:
        session_id = req.get("session") or f"conn_{conn.conn_id}"
        sess = self.sessions.get(session_id)
        if sess is None:
            sess = self.sessions[session_id] = _ClientSession()
        sess.conn_ids.add(conn.conn_id)
        self._conn_session[conn.conn_id] = session_id
        return sess

    async def _on_disconnect(self, conn):
        session_id = self._conn_session.pop(conn.conn_id, None)
        if session_id is None:
            return
        sess = self.sessions.get(session_id)
        if sess is None:
            return
        sess.conn_ids.discard(conn.conn_id)
        if not sess.conn_ids:
            spawn(self._reap_after_grace(session_id), what="client-session reap")

    async def _reap_after_grace(self, session_id: str):
        await asyncio.sleep(_REAP_GRACE_S)
        sess = self.sessions.get(session_id)
        if sess is None or sess.conn_ids:
            return  # reconnected within the grace window
        self.sessions.pop(session_id, None)
        # reap this client's refs + the actors it CREATED (detached actors
        # and shared actors merely looked up via GetActor survive)
        try:
            from ray_tpu_torch._private.worker import global_worker

            global_worker().free_objects(list(sess.refs.values()))
        except Exception:
            pass
        for handle in sess.owned_actors.values():
            try:
                ray_tpu_torch.kill(handle)
            except Exception:
                pass

    async def _handle(self, method: str, payload: bytes, conn) -> bytes:
        # trusted ingress: payloads execute code on load, so this port must
        # stay inside the cluster trust boundary (no auth of its own); every
        # unpickle goes through the audited serialization chokepoint (SER001)
        req = loads_trusted(payload) if payload else {}
        sess = self._session(conn, req)
        loop = asyncio.get_event_loop()

        def blocking(fn, *args, **kw):
            # every cluster op blocks on CoreWorker round-trips: keep them
            # off this event loop so one slow client can't stall the rest
            return loop.run_in_executor(self._pool, lambda: fn(*args, **kw))

        if method == "Put":
            ref = await blocking(ray_tpu_torch.put, loads_trusted(req["blob"]))
            sess.refs[ref.binary()] = ref
            return pickle.dumps({"ref": ref.binary()})

        if method == "Get":
            refs = [sess.refs[r] for r in req["refs"]]
            try:
                values = await blocking(
                    ray_tpu_torch.get, refs, timeout=req.get("timeout"))
                return pickle.dumps({"status": "ok",
                                     "blob": dumps(values)})
            except Exception as e:
                return pickle.dumps({"status": "error",
                                     "error": dumps(e)})

        if method == "Wait":
            refs = [sess.refs[r] for r in req["refs"]]
            ready, pending = await blocking(
                ray_tpu_torch.wait, refs, num_returns=req["num_returns"],
                timeout=req.get("timeout"))
            return pickle.dumps({"ready": [r.binary() for r in ready],
                                 "pending": [r.binary() for r in pending]})

        if method == "SubmitTask":
            fn = sess.functions.get(req["fn_hash"])
            if fn is None:
                fn = ray_tpu_torch.remote(loads_trusted(req["fn_blob"]))
                sess.functions[req["fn_hash"]] = fn
            args, kwargs = self._rebuild_args(sess, req["args_blob"])
            opts = req.get("options") or {}
            target = fn.options(**opts) if opts else fn
            out = await blocking(target.remote, *args, **kwargs)
            out_list = out if isinstance(out, list) else [out]
            for r in out_list:
                sess.refs[r.binary()] = r
            return pickle.dumps({"refs": [r.binary() for r in out_list]})

        if method == "CreateActor":
            cls = sess.classes.get(req["cls_hash"])
            if cls is None:
                cls = ray_tpu_torch.remote(loads_trusted(req["cls_blob"]))
                sess.classes[req["cls_hash"]] = cls
            args, kwargs = self._rebuild_args(sess, req["args_blob"])
            opts = req.get("options") or {}
            target = cls.options(**opts) if opts else cls
            handle = await blocking(target.remote, *args, **kwargs)
            sess.actors[handle.actor_id.binary()] = handle
            if opts.get("lifetime") != "detached":
                sess.owned_actors[handle.actor_id.binary()] = handle
            return pickle.dumps({
                "actor_id": handle.actor_id.binary(),
                "methods": handle._method_names,
                "class_name": handle._class_name,
            })

        if method == "SubmitActorTask":
            handle = sess.actors[req["actor_id"]]
            args, kwargs = self._rebuild_args(sess, req["args_blob"])
            m = getattr(handle, req["method"])
            if req.get("options"):
                m = m.options(**req["options"])
            out = await blocking(m.remote, *args, **kwargs)
            out_list = out if isinstance(out, list) else [out]
            for r in out_list:
                sess.refs[r.binary()] = r
            return pickle.dumps({"refs": [r.binary() for r in out_list]})

        if method == "GetActor":
            handle = await blocking(
                ray_tpu_torch.get_actor, req["name"], req.get("namespace"))
            sess.actors[handle.actor_id.binary()] = handle
            return pickle.dumps({
                "actor_id": handle.actor_id.binary(),
                "methods": handle._method_names,
                "class_name": handle._class_name,
            })

        if method == "KillActor":
            handle = sess.actors.get(req["actor_id"])
            if handle is not None:
                await blocking(ray_tpu_torch.kill, handle,
                               no_restart=req.get("no_restart", True))
                sess.owned_actors.pop(req["actor_id"], None)
            return pickle.dumps({"status": "ok"})

        if method == "ClusterInfo":
            return pickle.dumps({
                "cluster_resources": await blocking(ray_tpu_torch.cluster_resources),
                "available_resources": await blocking(ray_tpu_torch.available_resources),
                "nodes": await blocking(ray_tpu_torch.nodes),
            })

        if method == "ReleaseRefs":
            refs = [sess.refs.pop(r, None) for r in req["refs"]]
            refs = [r for r in refs if r is not None]
            if refs:
                try:
                    from ray_tpu_torch._private.worker import global_worker

                    await blocking(global_worker().free_objects, refs)
                except Exception:
                    pass
            return pickle.dumps({"released": len(refs)})

        if method == "RequestResources":
            from ray_tpu_torch.autoscaler.sdk import request_resources

            await blocking(request_resources, bundles=req["shapes"])
            return pickle.dumps({"status": "ok"})

        if method == "Ping":
            return pickle.dumps({"ok": True})

        raise ValueError(f"client proxy: unknown method {method}")

    def _rebuild_args(self, sess, blob):
        """Client-side refs arrive as markers; swap in the proxy's refs."""
        args, kwargs = loads_trusted(blob)

        def fix(v):
            if isinstance(v, _RefMarker):
                return sess.refs[v.ref_id]
            return v

        return [fix(a) for a in args], {k: fix(v) for k, v in kwargs.items()}


class _RefMarker:
    __slots__ = ("ref_id",)

    def __init__(self, ref_id: bytes):
        self.ref_id = ref_id

    def __reduce__(self):
        return (_RefMarker, (self.ref_id,))


def start_client_server(port: int = 10001, host: str = "0.0.0.0",
                        address: Optional[str] = None):
    """Run a client proxy (blocking). Connects to the cluster first when
    ``address`` is given, else expects ray_tpu_torch to already be initialized."""
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(address=address)

    async def run():
        proxy = ClientProxyServer(host, port)
        addr = await proxy.start()
        print(f"ray-tpu client server listening on {addr}", flush=True)
        await asyncio.Event().wait()

    asyncio.run(run())
