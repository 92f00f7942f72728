"""The port's gRPC ingress (``ray_tpu_torch/serve/grpc_ingress.py``) and
its HTTP/2 transport (``ray_tpu_torch/serve/_http2.py``), on the CPU.

- A mirror of ``tests/test_serve_grpc.py`` on a port cluster, without its
  ``importorskip("grpc")``: the port's ingress needs no ``grpcio``.
- The same deployment and requests through the JAX ingress (``grpcio``, a
  JAX cluster) and the port's: results, stream chunks and status codes
  equal.
- Interop both ways with ``grpcio``: a ``grpcio`` client (the JAX
  ``ServeGrpcClient``, a raw ``channel.unary_unary``) against the port's
  ingress and server, and the port's client against a plain
  ``grpc.server``: unary, streams, 4 MiB bodies each way (flow control),
  a request over the servers' 4 MiB limit refused, 16 concurrent calls on one channel, deadlines, cancels mid-stream (the
  replica's generator cancelled) and error codes with their messages.
- HPACK: RFC 7541's examples, the Huffman code against ``grpcio``'s
  encoder (binary metadata) and ``curl``'s nghttp2 encoder (every printable
  byte), its padding rules, and the dynamic table's evictions; HTTP/2
  framing between two in-memory connections (CONTINUATION, flow control,
  PING, SETTINGS, RST_STREAM).

Deployment targets defined inside a test travel by value; nothing at this
module's top level imports ``grpc`` or the JAX package.
"""

import base64
import os
import shutil
import socket
import subprocess
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch._private import wire
from ray_tpu_torch.serve import _http2 as h2
from ray_tpu_torch.serve.grpc_ingress import (SERVICE, GrpcError,
                                              ServeGrpcClient, StatusCode,
                                              start_grpc_proxy)

T = 120
MiB = 1 << 20
# a blob whose request, in its wire envelope, stays within the 4 MiB that
# the ingress (as grpcio's server) admits
NEAR_4MIB = 4 * MiB - 256
# grpcio refuses messages over 4 MiB unless told otherwise
GRPC_OPTIONS = [("grpc.max_receive_message_length", -1),
                ("grpc.max_send_message_length", -1)]


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8, device="cpu")
    yield
    try:
        serve.shutdown()
    except Exception:
        pass
    ray_tpu_torch.shutdown()


def _wait(pred, timeout=30.0, step=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


# ---------------------------------------------------------------------------
# tests/test_serve_grpc.py
# ---------------------------------------------------------------------------


def test_grpc_unary_and_stream(cluster):
    @serve.deployment
    class Api:
        def __call__(self, body):
            return {"sum": sum(body.get("xs", []))}

        async def tokens(self, body):
            import asyncio

            for i in range(int(body.get("n", 3))):
                await asyncio.sleep(0.2)
                yield {"tok": i}

    serve.run(Api.bind(), name="api")
    port = start_grpc_proxy()
    client = ServeGrpcClient(f"127.0.0.1:{port}")
    try:
        assert client.call("api", {"xs": [1, 2, 3]}) == {"sum": 6}

        t0 = time.monotonic()
        first_at = None
        chunks = []
        for chunk in client.stream("api", {"n": 3}, method="tokens"):
            if first_at is None:
                first_at = time.monotonic() - t0
            chunks.append(chunk)
        assert chunks == [{"tok": 0}, {"tok": 1}, {"tok": 2}]
        assert first_at < 0.55, f"stream not incremental: {first_at:.2f}s"
    finally:
        client.close()
        serve.delete("api")


def test_grpc_unknown_deployment_errors(cluster):
    @serve.deployment
    def noop(body):
        return 1

    serve.run(noop.bind(), name="noop")
    port = start_grpc_proxy()
    client = ServeGrpcClient(f"127.0.0.1:{port}")
    try:
        with pytest.raises(GrpcError) as err:
            client.call("no-such-deployment", {}, timeout=15.0)
        assert err.value.code() == StatusCode.NOT_FOUND
        assert "no-such-deployment" in err.value.details()
    finally:
        client.close()
        serve.delete("noop")


# ---------------------------------------------------------------------------
# the port's ingress held against the JAX ingress
# ---------------------------------------------------------------------------


def _api_class():
    """The deployment both ingresses serve (defined here so that both
    runtimes send it by value)."""

    class Api:
        def __call__(self, body):
            import numpy as np

            xs = body.get("xs", [])
            return {"sum": sum(xs),
                    "arr": np.arange(len(xs), dtype=np.int32),
                    "tags": set(body.get("tags", []))}

        async def tokens(self, body):
            for i in range(int(body.get("n", 3))):
                yield {"tok": i, "sq": i * i}

        def boom(self, body):
            raise ValueError("boom")

    return Api


_REQUESTS = [{"xs": [1, 2, 3]}, {"xs": [], "tags": ["a", "b"]},
             {"xs": list(range(100))}]


def _drive(client, calls_error):
    """What a client sees from one ingress: results, stream chunks, and the
    status codes and messages of an unknown deployment, a missing field, a
    raising replica and a request over 4 MiB."""
    out = {"results": [client.call("cmp", r, timeout=60) for r in _REQUESTS],
           "chunks": list(client.stream("cmp", {"n": 4}, method="tokens")),
           "errors": []}
    for fn in (lambda: client.call("no-such", {}, timeout=15),
               lambda: client._call({"body": {}}, timeout=30),
               lambda: client.call("cmp", {}, method="boom", timeout=30),
               lambda: client.call("cmp", {"blob": b"x" * (4 * MiB)},
                                   timeout=30)):
        out["errors"].append(calls_error(fn))
    return out


def _norm(out):
    """numpy arrays as lists (arrays do not compare with ==), and a remote
    error's message cut to its first and last lines (the traceback between
    names each package's files)."""
    res = [{**r, "arr": r["arr"].tolist(), "dtype": str(r["arr"].dtype)}
           for r in out["results"]]
    errors = [(code, details.strip().splitlines()[0],
               details.strip().splitlines()[-1]) for code, details in
              out["errors"]]
    return {**out, "results": res, "errors": errors}


def test_grpc_ingress_answers_as_the_jax_ingress(cluster):
    grpc = pytest.importorskip("grpc")
    pytest.importorskip("flax")
    import ray_tpu
    from ray_tpu import serve as jax_serve
    from ray_tpu.serve import grpc_ingress as jax_ingress

    def jax_error(fn):
        try:
            fn()
        except grpc.RpcError as e:
            return e.code().name, e.details()
        return None

    def port_error(fn):
        try:
            fn()
        except GrpcError as e:
            return e.code().name, e.details()
        return None

    ray_tpu.shutdown()
    ray_tpu.init(num_cpus=4)
    try:
        jax_serve.run(jax_serve.deployment(_api_class(), name="cmp").bind(),
                      name="cmp")
        jport = jax_ingress.start_grpc_proxy()
        jclient = jax_ingress.ServeGrpcClient(f"127.0.0.1:{jport}")
        want = _drive(jclient, jax_error)
        jclient.close()
        jax_serve.shutdown()
    finally:
        ray_tpu.shutdown()

    serve.run(serve.deployment(_api_class(), name="cmp").bind(), name="cmp")
    client = ServeGrpcClient(f"127.0.0.1:{start_grpc_proxy()}")
    try:
        got = _drive(client, port_error)
    finally:
        client.close()
        serve.delete("cmp")
    assert _norm(got) == _norm(want)
    # a missing field is a KeyError, which is a LookupError: both handlers
    # answer it NOT_FOUND before their INVALID_ARGUMENT clause
    assert [e[0] for e in got["errors"]] == ["NOT_FOUND", "NOT_FOUND",
                                             "INTERNAL", "RESOURCE_EXHAUSTED"]
    assert got["chunks"] == [{"tok": i, "sq": i * i} for i in range(4)]


# ---------------------------------------------------------------------------
# a grpcio client against the port's ingress
# ---------------------------------------------------------------------------


def _echo_class():
    """A deployment for the interop tests: echoes bodies, streams slowly
    and records its progress (and its cancellation) in a file."""

    class Echo:
        def __call__(self, body):
            import time as _time

            if body.get("sleep"):
                _time.sleep(body["sleep"])
            if body.get("fail"):
                raise RuntimeError(body["fail"])
            blob = body.get("blob", b"")
            return {"n": len(blob), "blob": blob, "i": body.get("i")}

        async def tokens(self, body):
            import asyncio

            path = body["log"]
            try:
                for i in range(int(body.get("n", 50))):
                    with open(path, "a") as f:
                        f.write(f"{i}\n")
                    yield {"tok": i}
                    await asyncio.sleep(body.get("gap", 0.1))
            except (asyncio.CancelledError, GeneratorExit):
                with open(path, "a") as f:
                    f.write("cancelled\n")
                raise

    return Echo


@pytest.fixture(scope="module")
def echo_port(cluster):
    serve.run(serve.deployment(_echo_class(), name="echo").bind(),
              name="echo")
    yield start_grpc_proxy()
    serve.delete("echo")


def _lines(path):
    try:
        with open(path) as f:
            return f.read().split()
    except FileNotFoundError:
        return []


def _assert_generator_cancelled(log):
    assert _wait(lambda: "cancelled" in _lines(log), timeout=30), \
        f"the replica's generator was not cancelled: {_lines(log)}"
    produced = len(_lines(log))
    time.sleep(0.5)
    assert len(_lines(log)) == produced  # and it produces no more
    assert produced < 40, produced


def test_grpcio_client_calls_the_port_ingress(cluster, echo_port, tmp_path):
    grpc = pytest.importorskip("grpc")
    pytest.importorskip("flax")
    from ray_tpu.serve.grpc_ingress import ServeGrpcClient as JaxClient

    address = f"127.0.0.1:{echo_port}"
    jclient = JaxClient(address)
    channel = grpc.insecure_channel(address, options=GRPC_OPTIONS)
    call = channel.unary_unary(f"/{SERVICE}/Call",
                               request_serializer=wire.dumps,
                               response_deserializer=wire.loads)
    try:
        # unary and stream through the JAX client
        assert jclient.call("echo", {"blob": b"abc", "i": 1}) == \
            {"n": 3, "blob": b"abc", "i": 1}
        log = str(tmp_path / "full.log")
        chunks = list(jclient.stream("echo", {"n": 3, "gap": 0.0, "log": log},
                                     method="tokens"))
        assert chunks == [{"tok": i} for i in range(3)]
        # a 4 MiB body each way, on a raw grpcio channel; a request over
        # 4 MiB is refused, as grpcio's server refuses it
        blob = os.urandom(NEAR_4MIB)
        out = call({"deployment": "echo", "body": {"blob": blob}},
                   timeout=60)["result"]
        assert out["n"] == len(blob) and out["blob"] == blob
        with pytest.raises(grpc.RpcError) as err:
            call({"deployment": "echo", "body": {"blob": blob + blob[:512]}},
                 timeout=60)
        assert err.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
        # 16 concurrent calls on one channel
        results = {}

        def one(i):
            results[i] = call({"deployment": "echo", "body": {"i": i}},
                              timeout=60)["result"]["i"]

        threads = [threading.Thread(target=one, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert results == {i: i for i in range(16)}
        # a deadline that expires
        with pytest.raises(grpc.RpcError) as err:
            call({"deployment": "echo", "body": {"sleep": 3.0}}, timeout=0.5)
        assert err.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED
        # an error's code and message
        with pytest.raises(grpc.RpcError) as err:
            jclient.call("echo", {"fail": "bad input: 100% wrong"})
        assert err.value.code() == grpc.StatusCode.INTERNAL
        assert "bad input: 100% wrong" in err.value.details()
        with pytest.raises(grpc.RpcError) as err:
            jclient.call("no-such", {}, timeout=15)
        assert err.value.code() == grpc.StatusCode.NOT_FOUND
        # a cancel mid-stream reaches the replica's generator
        log = str(tmp_path / "cancel.log")
        stream = jclient.stream("echo", {"n": 200, "gap": 0.1, "log": log},
                                method="tokens")
        assert [next(stream), next(stream)] == [{"tok": 0}, {"tok": 1}]
        stream.close()
        _assert_generator_cancelled(log)
    finally:
        jclient.close()
        channel.close()


# ---------------------------------------------------------------------------
# the port's client against the port's ingress and against grpc.server
# ---------------------------------------------------------------------------


def test_port_client_calls_the_port_ingress(cluster, echo_port, tmp_path):
    client = ServeGrpcClient(f"127.0.0.1:{echo_port}")
    try:
        blob = os.urandom(NEAR_4MIB)
        out = client.call("echo", {"blob": blob}, timeout=60)
        assert out["n"] == len(blob) and out["blob"] == blob
        with pytest.raises(GrpcError) as err:
            client.call("echo", {"blob": blob + blob[:512]}, timeout=60)
        assert err.value.code() == StatusCode.RESOURCE_EXHAUSTED
        assert "larger than max" in err.value.details()
        results = {}

        def one(i):
            results[i] = client.call("echo", {"i": i}, timeout=60)["i"]

        threads = [threading.Thread(target=one, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert results == {i: i for i in range(16)}
        with pytest.raises(GrpcError) as err:
            client._call({"deployment": "echo", "body": {"sleep": 3.0}},
                         timeout=0.5)
        assert err.value.code() == StatusCode.DEADLINE_EXCEEDED
        with pytest.raises(GrpcError) as err:
            client.call("echo", {"fail": "bad input: 100% wrong é"})
        assert err.value.code() == StatusCode.INTERNAL
        assert "bad input: 100% wrong é" in err.value.details()
        log = str(tmp_path / "cancel.log")
        stream = client.stream("echo", {"n": 200, "gap": 0.1, "log": log},
                               method="tokens")
        assert [next(stream), next(stream)] == [{"tok": 0}, {"tok": 1}]
        stream.close()
        _assert_generator_cancelled(log)
    finally:
        client.close()


@pytest.fixture
def grpcio_server():
    """A plain ``grpc.server`` with the ingress's method paths and ``wire``
    bodies, and a record of what its handlers saw."""
    grpc = pytest.importorskip("grpc")
    from concurrent import futures

    seen = {"stream_done": threading.Event(), "stream_active": None}

    def call(req, ctx):
        body = req.get("body", {})
        if body.get("sleep"):
            time.sleep(body["sleep"])
        if body.get("fail"):
            ctx.abort(grpc.StatusCode.FAILED_PRECONDITION, body["fail"])
        return {"result": {"n": len(body.get("blob", b"")),
                           "blob": body.get("blob", b""), "i": body.get("i")}}

    def stream(req, ctx):
        try:
            for i in range(int(req["body"].get("n", 3))):
                if not ctx.is_active():
                    break
                yield {"chunk": {"tok": i}}
                time.sleep(req["body"].get("gap", 0.0))
        finally:
            seen["stream_active"] = ctx.is_active()
            seen["stream_done"].set()

    class Generic(grpc.GenericRpcHandler):
        def service(self, details):
            if details.method == f"/{SERVICE}/Call":
                return grpc.unary_unary_rpc_method_handler(
                    call, request_deserializer=wire.loads,
                    response_serializer=wire.dumps)
            if details.method == f"/{SERVICE}/Stream":
                return grpc.unary_stream_rpc_method_handler(
                    stream, request_deserializer=wire.loads,
                    response_serializer=wire.dumps)
            return None

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=20),
                         handlers=(Generic(),), options=GRPC_OPTIONS)
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    yield port, seen
    server.stop(0)


def test_port_client_calls_a_grpcio_server(grpcio_server):
    port, seen = grpcio_server
    client = ServeGrpcClient(f"127.0.0.1:{port}")
    try:
        assert client.call("x", {"i": 7})["i"] == 7
        assert list(client.stream("x", {"n": 3})) == [{"tok": i}
                                                      for i in range(3)]
        blob = os.urandom(4 * MiB)
        out = client.call("x", {"blob": blob}, timeout=60)
        assert out["n"] == len(blob) and out["blob"] == blob
        results = {}

        def one(i):
            results[i] = client.call("x", {"i": i, "sleep": 0.2},
                                     timeout=60)["i"]

        threads = [threading.Thread(target=one, args=(i,)) for i in range(16)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert results == {i: i for i in range(16)}
        assert time.monotonic() - t0 < 16 * 0.2  # they ran at once
        with pytest.raises(GrpcError) as err:
            client._call({"body": {"sleep": 2.0}}, timeout=0.3)
        assert err.value.code() == StatusCode.DEADLINE_EXCEEDED
        with pytest.raises(GrpcError) as err:
            client.call("x", {"fail": "not now: 50% done, ünïcode"})
        assert err.value.code() == StatusCode.FAILED_PRECONDITION
        assert err.value.details() == "not now: 50% done, ünïcode"
        seen["stream_done"].clear()
        stream = client.stream("x", {"n": 500, "gap": 0.05})
        assert next(stream) == {"tok": 0}
        stream.close()
        assert seen["stream_done"].wait(10)
        assert seen["stream_active"] is False
    finally:
        client.close()


# ---------------------------------------------------------------------------
# the port's server against grpcio and the port's client, transport level
# ---------------------------------------------------------------------------


@pytest.fixture
def port_server():
    seen = {"inactive_after": None, "stream_active": None,
            "stream_done": threading.Event()}

    def echo(req, ctx):
        return req

    def wait_deadline(req, ctx):
        t0 = time.monotonic()
        while ctx.is_active() and time.monotonic() - t0 < 10:
            time.sleep(0.01)
        seen["inactive_after"] = time.monotonic() - t0
        return req

    def fail(req, ctx):
        ctx.abort(StatusCode.PERMISSION_DENIED, req.decode())

    def count(req, ctx):
        try:
            for i in range(int(req)):
                if not ctx.is_active():
                    return
                yield str(i).encode()
                time.sleep(0.02)
        finally:
            seen["stream_active"] = ctx.is_active()
            seen["stream_done"].set()

    methods = {"/t.S/Echo": h2.unary_unary_rpc_method_handler(echo),
               "/t.S/Wait": h2.unary_unary_rpc_method_handler(wait_deadline),
               "/t.S/Fail": h2.unary_unary_rpc_method_handler(fail),
               "/t.S/Count": h2.unary_stream_rpc_method_handler(count)}
    server = h2.GrpcServer(lambda d: methods.get(d.method))
    port = server.start()
    yield port, seen
    server.stop()


def test_grpcio_client_calls_the_port_server(port_server):
    grpc = pytest.importorskip("grpc")
    port, seen = port_server
    channel = grpc.insecure_channel(f"127.0.0.1:{port}", options=GRPC_OPTIONS)
    try:
        echo = channel.unary_unary("/t.S/Echo")
        blob = os.urandom(4 * MiB)
        assert echo(blob, timeout=60) == blob
        results = {}

        def one(i):
            results[i] = echo(b"%d" % i * 1000, timeout=60)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert results == {i: b"%d" % i * 1000 for i in range(16)}
        assert list(channel.unary_stream("/t.S/Count")(b"4")) == \
            [b"0", b"1", b"2", b"3"]
        with pytest.raises(grpc.RpcError) as err:
            channel.unary_unary("/t.S/Fail")("nope: 10% é".encode())
        assert err.value.code() == grpc.StatusCode.PERMISSION_DENIED
        assert err.value.details() == "nope: 10% é"
        with pytest.raises(grpc.RpcError) as err:
            channel.unary_unary("/t.S/Missing")(b"")
        assert err.value.code() == grpc.StatusCode.UNIMPLEMENTED
        with pytest.raises(grpc.RpcError) as err:
            channel.unary_unary("/t.S/Wait")(b"", timeout=0.3)
        assert err.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED
        assert _wait(lambda: seen["inactive_after"] is not None, 10)
        assert seen["inactive_after"] < 2.0
        seen["stream_done"].clear()
        stream = channel.unary_stream("/t.S/Count")(b"1000")
        assert next(stream) == b"0"
        stream.cancel()
        assert seen["stream_done"].wait(10)
        assert seen["stream_active"] is False
    finally:
        channel.close()


def test_port_client_calls_the_port_server(port_server):
    port, seen = port_server
    channel = h2.GrpcChannel(f"127.0.0.1:{port}")
    try:
        echo = channel.unary_unary("/t.S/Echo")
        blob = os.urandom(4 * MiB)  # the largest request the server admits
        assert echo(blob, timeout=60) == blob
        with pytest.raises(GrpcError) as err:
            echo(blob + b"abc", timeout=60)
        assert err.value.code() == StatusCode.RESOURCE_EXHAUSTED
        assert err.value.details() == (f"SERVER: Received message larger "
                                       f"than max ({4 * MiB + 3} vs. "
                                       f"{4 * MiB})")
        assert echo(b"after", timeout=10) == b"after"
        with pytest.raises(GrpcError) as err:
            channel.unary_unary("/t.S/Wait")(b"", timeout=0.3)
        assert err.value.code() == StatusCode.DEADLINE_EXCEEDED
        # the server applied grpc-timeout itself
        assert _wait(lambda: seen["inactive_after"] is not None, 10)
        assert seen["inactive_after"] < 2.0
        seen["stream_done"].clear()
        stream = channel.unary_stream("/t.S/Count")(b"1000")
        assert next(stream) == b"0"
        stream.close()
        assert seen["stream_done"].wait(10)
        assert seen["stream_active"] is False
        with pytest.raises(GrpcError) as err:
            channel.unary_unary("/t.S/Fail")(b"x")
        assert err.value.code() == StatusCode.PERMISSION_DENIED
    finally:
        channel.close()


# ---------------------------------------------------------------------------
# HPACK
# ---------------------------------------------------------------------------


_RFC_HUFFMAN = {  # RFC 7541 Appendix C.4 and C.6
    "www.example.com": "f1e3c2e5f23a6ba0ab90f4ff",
    "no-cache": "a8eb10649cbf",
    "custom-key": "25a849e95ba97d7f",
    "custom-value": "25a849e95bb8e8b4bf",
    "302": "6402", "307": "640eff", "private": "aec3771a4b", "gzip": "9bd9ab",
    "Mon, 21 Oct 2013 20:13:21 GMT":
        "d07abe941054d444a8200595040b8166e082a62d1bff",
    "https://www.example.com": "9d29ad171863c78f0b97c8e9ae82ae43d3",
    "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1":
        "94e7821dd7f2e6c7b335dfdfcd5b3960d5af27087f3672c1ab270fb5291f9587"
        "316065c003ed4ee5b1063d5007"}


@pytest.mark.parametrize("text", sorted(_RFC_HUFFMAN))
def test_huffman_decodes_the_rfc_examples(text):
    assert h2.huffman_decode(bytes.fromhex(_RFC_HUFFMAN[text])) == \
        text.encode()


def test_huffman_table_is_a_complete_canonical_code():
    from fractions import Fraction

    codes = h2.HUFFMAN_CODES
    assert len(codes) == 257 and codes[256] == ((1 << 30) - 1, 30)
    assert sum(Fraction(1, 1 << n) for _, n in codes) == 1
    ordered = sorted(range(257), key=lambda s: (codes[s][1], s))
    code = 0
    for prev, sym in zip([None] + ordered, ordered):
        if prev is not None:
            code = (code + 1) << (codes[sym][1] - codes[prev][1])
        assert codes[sym][0] == code, sym


def _huffman_encode(data: bytes, pad_bits=None, pad_value=None) -> bytes:
    acc, n = 0, 0
    for b in data:
        code, length = h2.HUFFMAN_CODES[b]
        acc, n = (acc << length) | code, n + length
    pad = (-n) % 8 if pad_bits is None else pad_bits
    value = (1 << pad) - 1 if pad_value is None else pad_value
    acc, n = (acc << pad) | value, n + pad
    return acc.to_bytes(n // 8, "big")


def test_huffman_round_trips_every_octet_and_refuses_bad_padding():
    data = bytes(range(256))
    assert h2.huffman_decode(_huffman_encode(data)) == data
    assert h2.huffman_decode(_huffman_encode(b"")) == b""
    with pytest.raises(h2.HpackError, match="longer than 7"):
        h2.huffman_decode(_huffman_encode(b"ab", pad_bits=(-10) % 8 + 8))
    with pytest.raises(h2.HpackError, match="prefix of EOS"):
        h2.huffman_decode(_huffman_encode(b"a", pad_value=0))  # 3 zero bits
    eos = ((h2.HUFFMAN_CODES[ord("a")][0] << 30) | ((1 << 30) - 1)) << 5 | 31
    with pytest.raises(h2.HpackError, match="EOS"):
        h2.huffman_decode(eos.to_bytes(5, "big"))


def test_hpack_decodes_the_rfc_request_sequence_with_its_table():
    """RFC 7541 C.4: three requests on one connection, Huffman-coded, the
    later ones indexing the dynamic table the earlier ones filled."""
    d = h2.HpackDecoder()
    assert d.decode(bytes.fromhex("828684418cf1e3c2e5f23a6ba0ab90f4ff")) == [
        (":method", "GET"), (":scheme", "http"), (":path", "/"),
        (":authority", "www.example.com")]
    assert d.decode(bytes.fromhex("828684be5886a8eb10649cbf"))[-1] == \
        ("cache-control", "no-cache")
    assert d.decode(bytes.fromhex(
        "828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf"))[-1] == \
        ("custom-key", "custom-value")
    assert [e[:2] for e in d._dynamic] == [
        ("custom-key", "custom-value"), ("cache-control", "no-cache"),
        (":authority", "www.example.com")]
    assert d._size == 164


def _literal_indexed(name: str, value: str) -> bytes:
    return (b"\x40" + bytes((len(name),)) + name.encode("latin-1")
            + bytes((len(value),)) + value.encode("latin-1"))


def test_hpack_dynamic_table_evicts_and_resizes():
    d = h2.HpackDecoder()
    # table size update to 100 octets: two 40-octet entries fit, the third
    # evicts the oldest
    block = bytes((0x20 | 31, 100 - 31)) + b"".join(
        _literal_indexed(f"k{i}", "v" * 5) for i in range(3))  # 2+5+32 each
    assert len(d.decode(block)) == 3
    assert [e[0] for e in d._dynamic] == ["k2", "k1"]
    assert d.decode(bytes((0x80 | 62, 0x80 | 63))) == [("k2", "vvvvv"),
                                                      ("k1", "vvvvv")]
    with pytest.raises(h2.HpackError):
        d.decode(bytes((0x80 | 64,)))  # evicted
    # an entry larger than the table empties it
    d.decode(_literal_indexed("big", "x" * 90))
    assert len(d._dynamic) == 0
    # sizes count octets (RFC 7541 4.1), also those of 0x80 and above: two
    # 50-octet entries fill the 100 exactly and both stay
    high = bytes(range(0xEF, 0x100)).decode("latin-1")  # 17 octets
    d.decode(_literal_indexed("a", high) + _literal_indexed("b", high))
    assert d.decode(bytes((0x80 | 62, 0x80 | 63))) == [("b", high),
                                                      ("a", high)]
    with pytest.raises(h2.HpackError, match="above the advertised"):
        d.decode(b"\x3f\xe2\x1f")  # a size update to 4097 > 4096
    with pytest.raises(h2.HpackError, match="after a field"):
        d.decode(b"\x82\x20")


def test_huffman_decoder_reads_grpcio_binary_metadata():
    """grpcio Huffman-codes only binary (``-bin``) metadata, as base64: each
    printable byte in a value of 20 comes back through the port's decoder
    (the base64 alphabet's codes)."""
    grpc = pytest.importorskip("grpc")
    metadata = [(f"k{b:02x}-bin", bytes([b]) * 20) for b in range(0x20, 0x7F)]
    got = _capture_headers(lambda port: _grpcio_call(grpc, port, metadata))
    headers, decoder = got
    fields = dict(headers)
    assert decoder.huffman_strings >= len(metadata)
    for key, value in metadata:
        assert base64.b64decode(fields[key] + "==") == value, key


def test_huffman_decoder_reads_nghttp2_huffman_of_every_printable_byte():
    """curl's HTTP/2 (nghttp2) Huffman-codes a value whenever that is
    shorter: each printable byte, between runs of 5-bit codes, comes back
    through the port's decoder."""
    curl = shutil.which("curl")
    if curl is None or "HTTP2" not in subprocess.run(
            [curl, "--version"], capture_output=True, text=True).stdout:
        pytest.skip("no curl with HTTP/2 on this machine")
    values = {f"k{b:02x}": "aaaaaaaa" + chr(b) + "eeeeeeee"
              for b in range(0x20, 0x7F)}
    args = [curl, "-s", "-o", os.devnull, "--http2-prior-knowledge"]
    for k, v in values.items():
        args += ["-H", f"{k}: {v}"]
    headers, decoder = _capture_headers(lambda port: subprocess.run(
        args + [f"http://127.0.0.1:{port}/probe"], capture_output=True,
        timeout=30))
    fields = dict(headers)
    assert decoder.huffman_strings >= len(values)
    assert {k: fields.get(k) for k in values} == values


def _grpcio_call(grpc, port, metadata):
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        channel.unary_unary("/probe.P/Q")(b"", metadata=metadata, timeout=10)
    except grpc.RpcError:
        pass  # the probe answers UNIMPLEMENTED
    finally:
        channel.close()


def _capture_headers(client):
    """Run ``client(port)`` against a raw socket server speaking the port's
    H2Connection; returns the first request's header fields and the
    decoder that read them."""
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    port = listener.getsockname()[1]
    got = {}

    def serve():
        sock, _ = listener.accept()
        sock.settimeout(20)
        conn = h2.H2Connection(client=False)
        conn.initiate()
        sock.sendall(conn.data_to_send())
        try:
            while "headers" not in got:
                data = sock.recv(1 << 16)
                if not data:
                    break
                for event in conn.receive(data):
                    if event[0] == "headers" and "headers" not in got:
                        got["headers"], got["sid"] = event[2], event[1]
                sock.sendall(conn.data_to_send())
            conn.send_headers(got["sid"], [
                (":status", "200"), ("content-type", "application/grpc"),
                ("grpc-status", "12")], end_stream=True)
            sock.sendall(conn.data_to_send())
            time.sleep(0.1)
        finally:
            sock.close()
            listener.close()
        got["decoder"] = conn.decoder

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    client(port)
    t.join(30)
    return got["headers"], got["decoder"]


# ---------------------------------------------------------------------------
# HTTP/2 framing between two in-memory connections
# ---------------------------------------------------------------------------


def _pump(a, b, rounds=20):
    """Move bytes between two connections until both are quiet; returns
    the events each side saw."""
    seen = {id(a): [], id(b): []}
    for _ in range(rounds):
        moved = False
        for src, dst in ((a, b), (b, a)):
            data = src.data_to_send()
            if data:
                moved = True
                seen[id(dst)] += dst.receive(data)
        if not moved:
            break
    return seen[id(a)], seen[id(b)]


def _frames(data: bytes):
    out, pos = [], 0
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 3], "big")
        out.append((data[pos + 3], data[pos + 4],
                    int.from_bytes(data[pos + 5:pos + 9], "big"), n))
        pos += 9 + n
    return out


def test_h2_flow_control_holds_data_until_window_updates():
    client, server = h2.H2Connection(True), h2.H2Connection(False)
    client.initiate()
    hello = client.data_to_send()
    server.receive(hello)  # the server has the client's SETTINGS
    # the server's own SETTINGS never reach the client yet: the client keeps
    # the default 65535-byte windows toward the server
    sid = client.new_stream_id()
    client.send_headers(sid, [(":method", "POST"), (":path", "/x")])
    client.send_data(sid, b"z" * 200_000, end_stream=True)
    first = client.data_to_send()
    sent = sum(n for kind, _, _, n in _frames(first) if kind == h2.DATA)
    assert sent == 65535
    assert max(n for kind, _, _, n in _frames(first) if kind == h2.DATA) \
        <= 16384
    events = server.receive(first)
    got = b"".join(e[2] for e in events if e[0] == "data")
    assert len(got) == 65535
    # the server's preface, SETTINGS ACK and WINDOW_UPDATEs release the rest
    c_events, s_events = _pump(client, server)
    got += b"".join(e[2] for e in s_events if e[0] == "data")
    assert got == b"z" * 200_000
    assert any(e[0] == "data" and e[3] for e in s_events)


def test_h2_headers_split_into_continuation_and_pings_are_acked():
    client, server = h2.H2Connection(True), h2.H2Connection(False)
    client.initiate()
    server.initiate()
    _pump(client, server)
    sid = client.new_stream_id()
    big = [("x-big", "v" * 40_000), (":path", "/p")]
    client.send_headers(sid, big, end_stream=True)
    data = client.data_to_send()
    kinds = [(k, f) for k, f, _, _ in _frames(data)]
    assert kinds[0][0] == h2.HEADERS and not kinds[0][1] & h2.FLAG_END_HEADERS
    assert kinds[-1] == (h2.CONTINUATION, h2.FLAG_END_HEADERS)
    assert all(n <= 16384 for *_, n in _frames(data))
    events = server.receive(data)
    assert events == [("headers", sid, big, True)]
    # PING: acked with its payload; SETTINGS: acked
    server.receive(h2._frame(h2.PING, 0, 0, b"12345678")
                   + h2._frame(h2.SETTINGS, 0, 0, (5).to_bytes(2, "big")
                               + (1 << 15).to_bytes(4, "big")))
    frames = server.data_to_send()
    assert (h2.PING, h2.FLAG_ACK, 0, 8) in _frames(frames)
    assert (h2.SETTINGS, h2.FLAG_ACK, 0, 0) in _frames(frames)
    assert frames.count(b"12345678") == 1 and server.peer_max_frame == 1 << 15


def test_h2_reset_and_protocol_errors():
    client, server = h2.H2Connection(True), h2.H2Connection(False)
    client.initiate()
    server.initiate()
    _pump(client, server)
    sid = client.new_stream_id()
    client.send_headers(sid, [(":path", "/p")])
    _pump(client, server)
    client.reset_stream(sid, h2.CANCEL)
    _, s_events = _pump(client, server)
    assert s_events == [("reset", sid, h2.CANCEL)]
    assert not server.send_data(sid, b"late")  # gone on the server
    with pytest.raises(h2.H2ProtocolError):
        server.receive(h2._frame(h2.CONTINUATION, 4, 9, b""))
    with pytest.raises(h2.H2ProtocolError):
        h2.H2Connection(False).receive(b"GET / HTTP/1.1\r\n\r\n" + b"x" * 8)


def test_grpc_message_and_timeout_encodings():
    for text in ("", "plain", "100% é\n☃"):
        assert h2.decode_grpc_message(h2.encode_grpc_message(text)) == text
    assert h2.encode_grpc_message("a%b") == "a%25b"
    for seconds in (0.0, 0.0005, 0.3, 10.0, 1e6):
        got = h2.decode_timeout(h2.encode_timeout(seconds))
        assert seconds <= got <= seconds * 1.001 + 1e-9
        assert len(h2.encode_timeout(seconds)) <= 9
    assert h2.decode_timeout("12x") is None
