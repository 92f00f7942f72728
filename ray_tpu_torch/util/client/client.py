"""Thin external client for ``ray-tpu://`` addresses.

Reference: python/ray/util/client/worker.py — the client-mode Worker that
ships pickled operations to the in-cluster proxy and wraps returned ids
as refs/handles. ``ray_tpu_torch.init(address="ray-tpu://host:port")`` installs
a :class:`ClientWorker` as the global worker; the whole public API
(remote/get/put/wait/actors) works unchanged from outside the cluster.

The port of ``ray_tpu/util/client/client.py``: functions, classes, arguments
and values go out through the port's pickler (``_private/serialization.py``:
by value where they cannot be imported by name), not ``cloudpickle``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import threading
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID
from ray_tpu_torch._private.rpc import RetryingRpcClient
from ray_tpu_torch._private.serialization import dumps, loads_trusted
from ray_tpu_torch.object_ref import ObjectRef


def _options_dict(opts) -> Dict[str, Any]:
    """Non-default dataclass fields -> kwargs for .options() on the proxy."""
    out = {}
    for f in dataclasses.fields(opts):
        value = getattr(opts, f.name)
        if f.default is not dataclasses.MISSING:
            default = f.default
        elif f.default_factory is not dataclasses.MISSING:  # type: ignore
            default = f.default_factory()  # type: ignore
        else:
            default = None
        if value != default:
            out[f.name] = value
    return out


class ClientWorker:
    """Global-worker implementation that proxies everything over one TCP
    connection to an in-cluster ClientProxyServer."""

    mode = "client"

    def __init__(self, address: str, namespace: str = "default"):
        import uuid

        # ray-tpu://host:port
        hostport = address.split("://", 1)[1]
        self.address = hostport
        self.namespace = namespace
        self.job_id = JobID.from_int(1)
        # session id rides every request so a transparent reconnect resumes
        # the same proxy-side session (refs/actors survive TCP blips)
        self.session_id = f"client_{uuid.uuid4().hex[:12]}"
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self.loop.run_forever, daemon=True, name="ray-tpu-client")
        self._thread.start()
        self.client = RetryingRpcClient(hostport)
        try:
            self._call("Ping", {}, timeout=30.0)
        except BaseException:
            # don't leak the loop thread when the endpoint is unreachable
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._thread.join(timeout=5)
            raise

    # -- plumbing ------------------------------------------------------

    # ops with side effects must not be blindly re-sent after a
    # post-delivery connection drop (double execution); pre-send failures
    # still retry safely inside RetryingRpcClient
    _MUTATING = ("Put", "SubmitTask", "CreateActor", "SubmitActorTask",
                 "KillActor")

    def _call(self, method: str, req: dict, timeout: Optional[float] = None):
        import pickle

        req = dict(req, session=self.session_id)
        retries = 0 if method in self._MUTATING else None
        fut = asyncio.run_coroutine_threadsafe(
            self.client.call(method, pickle.dumps(req),
                             timeout=timeout or 300.0, retries=retries),
            self.loop)
        # the proxy is inside the user's own trust domain; still route the
        # unpickle through the audited boundary
        return loads_trusted(fut.result(timeout=(timeout or 300.0) + 30))

    @staticmethod
    def _marker_args(args, kwargs) -> bytes:
        from ray_tpu_torch.util.client.server import _RefMarker

        def fix(v):
            if isinstance(v, ObjectRef):
                return _RefMarker(v.binary())
            return v

        return dumps(
            ([fix(a) for a in args], {k: fix(v) for k, v in kwargs.items()}))

    @staticmethod
    def _mk_refs(binaries: List[bytes]) -> List[ObjectRef]:
        return [ObjectRef(ObjectID(b)) for b in binaries]

    # -- objects -------------------------------------------------------

    def put(self, value: Any) -> ObjectRef:
        reply = self._call("Put", {"blob": dumps(value)})
        return ObjectRef(ObjectID(reply["ref"]))

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        reply = self._call("Get", {
            "refs": [r.binary() for r in ref_list],
            "timeout": timeout,
        }, timeout=(timeout or 86400.0) + 10)
        if reply["status"] == "error":
            raise loads_trusted(reply["error"])
        values = loads_trusted(reply["blob"])
        return values[0] if single else values

    def wait(self, refs, num_returns=1, timeout=None, fetch_local=True):
        reply = self._call("Wait", {
            "refs": [r.binary() for r in refs],
            "num_returns": num_returns, "timeout": timeout,
        }, timeout=(timeout or 86400.0) + 10)
        by_id = {r.binary(): r for r in refs}
        return ([by_id[b] for b in reply["ready"]],
                [by_id[b] for b in reply["pending"]])

    def free_objects(self, refs):
        """Explicit release on the proxy (automatic finalizer-driven GC is
        deferred; the session grace-reaper is the backstop)."""
        try:
            self._call("ReleaseRefs", {"refs": [r.binary() for r in refs]})
        except Exception:
            pass

    # -- tasks ---------------------------------------------------------

    def submit_task(self, remote_fn, args, kwargs, opts):
        blob = dumps(remote_fn.function)
        fn_hash = hashlib.sha1(blob).hexdigest()
        reply = self._call("SubmitTask", {
            "fn_hash": fn_hash, "fn_blob": blob,
            "args_blob": self._marker_args(args, kwargs),
            "options": _options_dict(opts),
        })
        refs = self._mk_refs(reply["refs"])
        return refs[0] if len(refs) == 1 else refs

    # -- actors --------------------------------------------------------

    def create_actor(self, actor_cls, args, kwargs, opts):
        from ray_tpu_torch.actor import ActorHandle

        blob = dumps(actor_cls.cls)
        cls_hash = hashlib.sha1(blob).hexdigest()
        reply = self._call("CreateActor", {
            "cls_hash": cls_hash, "cls_blob": blob,
            "args_blob": self._marker_args(args, kwargs),
            "options": _options_dict(opts),
        })
        return ActorHandle(ActorID(reply["actor_id"]), reply["methods"],
                           reply["class_name"])

    def submit_actor_task(self, handle, method_name, args, kwargs,
                          num_returns=1, tensor_transport=""):
        options = {}
        if num_returns != 1:
            options["num_returns"] = num_returns
        if tensor_transport:
            options["tensor_transport"] = tensor_transport
        reply = self._call("SubmitActorTask", {
            "actor_id": handle.actor_id.binary(), "method": method_name,
            "args_blob": self._marker_args(args, kwargs),
            "options": options,
        })
        refs = self._mk_refs(reply["refs"])
        return refs[0] if len(refs) == 1 else refs

    def get_actor(self, name: str, namespace: Optional[str] = None):
        from ray_tpu_torch.actor import ActorHandle

        reply = self._call("GetActor", {"name": name,
                                        "namespace": namespace or self.namespace})
        return ActorHandle(ActorID(reply["actor_id"]), reply["methods"],
                           reply["class_name"])

    def kill_actor(self, handle, no_restart=True):
        self._call("KillActor", {"actor_id": handle.actor_id.binary(),
                                 "no_restart": no_restart})

    def request_resources(self, shapes):
        """``autoscaler.sdk.request_resources`` from outside the cluster."""
        self._call("RequestResources", {"shapes": shapes})

    def cancel(self, ref, force=False, recursive=True):
        import logging

        logging.getLogger("ray_tpu_torch").warning(
            "ray_tpu_torch.cancel() is not supported in client mode yet; the "
            "task keeps running")

    # -- cluster info --------------------------------------------------

    def cluster_resources(self):
        return self._call("ClusterInfo", {})["cluster_resources"]

    def available_resources(self):
        return self._call("ClusterInfo", {})["available_resources"]

    def nodes(self):
        return self._call("ClusterInfo", {})["nodes"]

    # -- futures (rarely used from external clients) -------------------

    def as_future(self, ref):
        import concurrent.futures
        import threading as _th

        fut: "concurrent.futures.Future" = concurrent.futures.Future()

        def _resolve():
            try:
                fut.set_result(self.get(ref))
            except Exception as e:
                fut.set_exception(e)

        _th.Thread(target=_resolve, daemon=True).start()
        return fut

    async def await_ref(self, ref):
        # never block the caller's event loop on the round-trip
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, self.get, ref)

    def shutdown(self):
        try:
            asyncio.run_coroutine_threadsafe(
                self.client.close(), self.loop).result(timeout=5)
        except Exception:
            pass
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=5)
