"""The port's runtime codecs against the JAX runtime's, with no cluster: the
runtime's native msgpack and its pure-Python plain version against the
``msgpack`` package and each other, ``wire`` in both
directions, IDs and the object store's blob layout, the by-value pickler
with ``cloudpickle`` and ``msgpack`` blocked, tensors through the object
serializer, and GPU detection from the environment."""

import os
import subprocess
import sys
import tempfile
import textwrap

import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ray_tpu._private import common as jax_common
from ray_tpu._private import ids as jax_ids
from ray_tpu._private import object_store as jax_store
from ray_tpu._private import wire as jax_wire
from ray_tpu.weights.plan import TransferEdge as JaxTransferEdge
from ray_tpu.weights.spec import MeshSpec as JaxMeshSpec
from ray_tpu_torch._private import common, ids, object_store, wire
from ray_tpu_torch._private import msgpack as port_msgpack
from ray_tpu_torch._private import msgpack_plain, native_build
from ray_tpu_torch._private import serialization
from ray_tpu_torch.util import accelerators
from ray_tpu_torch.weights.plan import TransferEdge
from ray_tpu_torch.weights.spec import MeshSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# msgpack
# ---------------------------------------------------------------------------


class _Ext:
    """A library-neutral ext value, turned into each library's ExtType."""

    def __init__(self, code, data):
        self.code, self.data = code, data

    def __repr__(self):
        return f"_Ext({self.code}, {self.data!r})"


def _as(value, ext_type):
    if isinstance(value, _Ext):
        return ext_type(value.code, value.data)
    if isinstance(value, list):
        return [_as(v, ext_type) for v in value]
    if isinstance(value, dict):
        return {_as(k, ext_type): _as(v, ext_type) for k, v in value.items()}
    return value


_scalars = (st.none() | st.booleans()
            | st.integers(-(2 ** 63), 2 ** 64 - 1)
            | st.floats(allow_nan=False)
            | st.text() | st.binary()
            | st.builds(_Ext, st.integers(0, 127), st.binary()))
_values = st.recursive(
    _scalars,
    lambda inner: (st.lists(inner, max_size=20)
                   | st.dictionaries(st.text() | st.integers(-1000, 1000),
                                     inner, max_size=20)),
    max_leaves=40)


@settings(max_examples=300, deadline=None)
@given(_values)
def test_msgpack_matches_the_package_byte_for_byte(value):
    want = msgpack.packb(_as(value, msgpack.ExtType), use_bin_type=True)
    got = port_msgpack.packb(_as(value, port_msgpack.ExtType))
    assert got == want
    decoded = msgpack.unpackb(want, raw=False, strict_map_key=False)
    assert port_msgpack.unpackb(want) == decoded


@settings(max_examples=300, deadline=None)
@given(_values)
def test_plain_msgpack_matches_the_package_byte_for_byte(value):
    want = msgpack.packb(_as(value, msgpack.ExtType), use_bin_type=True)
    assert msgpack_plain.packb(_as(value, msgpack_plain.ExtType)) == want
    decoded = msgpack.unpackb(want, raw=False, strict_map_key=False)
    assert msgpack_plain.unpackb(want) == decoded


@settings(max_examples=300, deadline=None)
@given(_values | st.tuples(_values, _values) | st.binary(max_size=64))
def test_native_msgpack_equals_the_plain_codec(value):
    """The runtime's codec (``csrc/msgpack.cc``) packs what the plain one
    packs, and reads any bytes (well formed or not) to the same value or the
    same error."""
    if isinstance(value, tuple):
        value = tuple(_as(v, port_msgpack.ExtType) for v in value)
    else:
        value = _as(value, port_msgpack.ExtType)
    if isinstance(value, bytes) and value[:1] == b"\xff":
        blob = value[1:]  # arbitrary bytes to read
    else:
        blob = msgpack_plain.packb(value)
        assert port_msgpack.packb(value) == blob
        assert port_msgpack.packb(bytearray(blob)) == \
            msgpack_plain.packb(bytearray(blob))
    outcomes = []
    for codec in (port_msgpack, msgpack_plain):
        try:
            outcomes.append(("ok", codec.unpackb(blob)))
        except Exception as e:
            outcomes.append((type(e), str(e)))
    assert outcomes[0] == outcomes[1]


def _nest(depth):
    value = 0
    for _ in range(depth):
        value = [value]
    return value


@pytest.mark.parametrize("value", [
    2 ** 64, -(2 ** 63) - 1, object(), "\ud800", {"k": {1, 2}},
    _nest(512), _nest(513), memoryview(b"abc")[::2], 1.5, True, None,
    (1, "a", b"b"), {1: [2, {3: 4}]}])
def test_native_msgpack_packs_and_refuses_as_the_plain_codec(value):
    outcomes = []
    for codec in (port_msgpack, msgpack_plain):
        try:
            outcomes.append(("ok", codec.packb(value)))
        except Exception as e:
            outcomes.append((type(e), str(e)))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("blob", [
    b"\xc1", b"\x92\x01", b"\x01\x02", b"\xdd\xff\xff\xff\xff\x01",
    b"\xdf\xff\xff\xff\xff", b"\xa3ab", b"\xa2\xff\xfe",
    b"\x81\x91\x01\x02", b"\xd4\xff\x00", b"\xc7\x01\x80\x00",
    b"\xca\x3f\xc0\x00\x00", b"\xcb", b"", b"\x91" * 200 + b"\x00"],
    ids=lambda blob: blob[:6].hex() or "empty")
def test_native_msgpack_reads_and_refuses_as_the_plain_codec(blob):
    outcomes = []
    for codec in (port_msgpack, msgpack_plain):
        try:
            outcomes.append(("ok", codec.unpackb(blob)))
        except Exception as e:
            outcomes.append((type(e), str(e)))
    assert outcomes[0] == outcomes[1]
    hooked = [codec.unpackb(b"\xd4\x05\x07", ext_hook=lambda c, d: (c, d))
              for codec in (port_msgpack, msgpack_plain)]
    assert hooked == [(5, b"\x07")] * 2


def test_the_runtime_runs_the_native_codec_and_a_failed_build_raises(
        tmp_path, monkeypatch):
    """rpc and wire frame through the extension module, built into
    ``build/ray_tpu_torch/`` under its source's hash; a source that does not
    compile raises instead of falling back to the plain codec."""
    from ray_tpu_torch._private import rpc

    assert rpc.msgpack is port_msgpack and wire.msgpack is port_msgpack
    port_msgpack.packb(0)
    native = port_msgpack._native
    assert type(native.packb).__name__ == "builtin_function_or_method"
    assert os.path.dirname(native.__file__) == native_build.BUILD_DIR
    bad = tmp_path / "broken.cc"
    bad.write_text("#include <Python.h>\nint broken( {\n")
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_build.load_extension(str(bad), "broken")


# every width's edges: fixint, 8, 16, 32 and 64 bits, signed and unsigned
_INT_EDGES = sorted({s * (b + d) for b in (0, 31, 32, 127, 128, 255, 256,
                                           2 ** 15, 2 ** 16, 2 ** 31,
                                           2 ** 32, 2 ** 63)
                     for d in (-1, 0, 1) for s in (1, -1)
                     if -(2 ** 63) <= s * (b + d) < 2 ** 64}
                    | {2 ** 64 - 1})


@pytest.mark.parametrize("n", _INT_EDGES)
def test_msgpack_int_width_edges(n):
    want = msgpack.packb(n, use_bin_type=True)
    assert port_msgpack.packb(n) == want
    assert port_msgpack.unpackb(want) == n


@pytest.mark.parametrize("size", [0, 1, 2, 3, 4, 8, 15, 16, 17, 31, 32, 255,
                                  256, 65535, 65536])
def test_msgpack_length_edges(size):
    """str, bin, array, map and ext headers at each length's edges."""
    for value, ref in (("x" * size, "x" * size), (b"y" * size, b"y" * size),
                       (list(range(size)), list(range(size))),
                       ({i: None for i in range(size)},
                        {i: None for i in range(size)})):
        want = msgpack.packb(ref, use_bin_type=True)
        assert port_msgpack.packb(value) == want
        assert port_msgpack.unpackb(want) == ref
    if size:
        want = msgpack.packb(msgpack.ExtType(7, b"z" * size))
        assert port_msgpack.packb(port_msgpack.ExtType(7, b"z" * size)) == want
        assert port_msgpack.unpackb(want) == (7, b"z" * size)


def test_msgpack_refuses_what_the_package_refuses():
    for bad in (2 ** 64, -(2 ** 63) - 1):
        with pytest.raises(OverflowError):
            msgpack.packb(bad)
        with pytest.raises(OverflowError):
            port_msgpack.packb(bad)
    with pytest.raises(TypeError):
        port_msgpack.packb(object())
    with pytest.raises(ValueError):
        port_msgpack.unpackb(b"\xc1")
    with pytest.raises(ValueError):
        port_msgpack.unpackb(b"\x92\x01")  # an array of 2 holding 1 item
    with pytest.raises(port_msgpack.ExtraData):
        port_msgpack.unpackb(b"\x01\x02")
    hooked = port_msgpack.unpackb(
        msgpack.packb(msgpack.ExtType(5, b"ab")),
        ext_hook=lambda code, data: (code * 2, data[::-1]))
    assert hooked == (10, b"ba")


# ---------------------------------------------------------------------------
# wire
# ---------------------------------------------------------------------------


def _pair(make):
    """The same struct built by each package (``make(common, ids)``)."""
    return make(jax_common, jax_ids), make(common, ids)


_JOB = bytes.fromhex("0a0b0c0d")


def _structs():
    def node(c, i):
        return c.NodeInfo(i.NodeID(bytes(range(16))), "127.0.0.1:1",
                          "127.0.0.1:2", {"CPU": 4.0}, {"k": "v"},
                          is_head=True, start_time=12.5)

    def bundle(c, i):
        return c.Bundle({"CPU": 1.0}, {"zone": "a"})

    def pg_spec(c, i):
        return c.PlacementGroupSpec(i.PlacementGroupID(bytes(range(12))),
                                    [c.Bundle({"CPU": 2.0})], "SPREAD", "g",
                                    creator_job=i.JobID(_JOB))

    def lease(c, i):
        return c.WorkerLease("l1", "127.0.0.1:3", 42,
                             i.NodeID(bytes(range(16))), {"CPU": 1.0})

    def ids_list(c, i):
        job = i.JobID(_JOB)
        task = i.TaskID(bytes(range(10)) + _JOB)
        return [job, task, i.ObjectID.for_task_return(task, 3),
                i.ActorID(bytes(range(8)) + _JOB), i.WorkerID(bytes(range(16)))]

    out = [node, bundle, pg_spec, lease, ids_list]
    return [pytest.param(m, id=m.__name__) for m in out]


@pytest.mark.parametrize("make", _structs())
def test_wire_structs_byte_equal_both_ways(make):
    jax_value, port_value = _pair(make)
    jb, pb = jax_wire.dumps(jax_value), wire.dumps(port_value)
    assert pb == jb
    assert wire.dumps(wire.loads(jb)) == jb
    assert jax_wire.dumps(jax_wire.loads(pb)) == pb


def test_wire_weight_structs_byte_equal_both_ways():
    box = ((0, 4), (2, 8))
    jv = [JaxMeshSpec((2, 4), ("data", "fsdp"), (1, 2)),
          JaxTransferEdge("layer_0.w", 0, 1, box, box, box, 96, False)]
    pv = [MeshSpec((2, 4), ("data", "fsdp"), (1, 2)),
          TransferEdge("layer_0.w", 0, 1, box, box, box, 96, False)]
    jb, pb = jax_wire.dumps(jv), wire.dumps(pv)
    assert pb == jb
    assert wire.loads(jb) == pv
    assert jax_wire.loads(pb) == jv


def test_wire_scheduling_structs_byte_equal_both_ways():
    """The placement group handle and the strategy objects, which options
    carry to the GCS, cross the wire as the JAX package's do."""
    import importlib

    # ray_tpu.util re-exports the function placement_group: import modules
    jax_pg = importlib.import_module("ray_tpu.util.placement_group")
    jax_ss = importlib.import_module("ray_tpu.util.scheduling_strategies")
    pg = importlib.import_module("ray_tpu_torch.util.placement_group")
    ss = importlib.import_module("ray_tpu_torch.util.scheduling_strategies")

    def values(i, pgm, sm):
        group = pgm.PlacementGroup(i.PlacementGroupID(bytes(range(12))),
                                   [{"CPU": 1.0, "GPU": 1.0}])
        return [group, sm.PlacementGroupSchedulingStrategy(group, 1, True),
                sm.NodeAffinitySchedulingStrategy("ab" * 28, soft=True),
                sm.NodeLabelSchedulingStrategy({"k": "v"}, {"s": "t"}),
                sm.SpreadSchedulingStrategy()]

    jv, pv = values(jax_ids, jax_pg, jax_ss), values(ids, pg, ss)
    jb, pb = jax_wire.dumps(jv), wire.dumps(pv)
    assert pb == jb
    assert wire.dumps(wire.loads(jb)) == jb
    assert jax_wire.dumps(jax_wire.loads(pb)) == pb


@pytest.mark.parametrize("kind", ["TaskOptions", "ActorOptions", "TaskSpec"])
def test_wire_options_equal_but_for_the_accelerator_field(kind):
    """``num_tpus`` became ``num_gpus`` (names of one length): the bytes are
    the JAX bytes with that name replaced, and each side reads the other's,
    the unknown field dropped."""
    def opts(c, accel):
        cls = c.ActorOptions if kind == "ActorOptions" else c.TaskOptions
        return cls(num_cpus=2.0, resources={"x": 1.0}, name="n",
                   runtime_env={"env_vars": {"A": "1"}}, **accel)

    def build(c, i, accel):
        if kind != "TaskSpec":
            return opts(c, accel)
        task = i.TaskID(bytes(range(10)) + _JOB)
        return c.TaskSpec(task, i.JobID(_JOB), "fn", b"args", 1,
                          opts(c, accel), owner_address="a:1",
                          actor_options=None, trace_id="t")

    jv = build(jax_common, jax_ids, {"num_tpus": 1.0})
    pv = build(common, ids, {"num_gpus": 1.0})
    jb, pb = jax_wire.dumps(jv), wire.dumps(pv)
    assert pb == jb.replace(b"num_tpus", b"num_gpus")
    from_jax = wire.loads(jb)
    from_port = jax_wire.loads(pb)
    o1 = from_jax.options if kind == "TaskSpec" else from_jax
    o2 = from_port.options if kind == "TaskSpec" else from_port
    assert o1.num_gpus == 0.0 and o2.num_tpus == 0.0
    assert (o1.num_cpus, o1.resources, o1.runtime_env) == \
        (o2.num_cpus, o2.resources, o2.runtime_env) == \
        (2.0, {"x": 1.0}, {"env_vars": {"A": "1"}})


def test_wire_refuses_what_it_does_not_register():
    with pytest.raises(wire.WireError):
        wire.dumps(object())
    with pytest.raises(wire.WireError):
        wire.loads(b"\x80\x04\x95")  # a pickle's first bytes
    arr = np.arange(6, dtype=np.int16).reshape(2, 3)
    assert wire.dumps(arr) == jax_wire.dumps(arr)
    np.testing.assert_array_equal(wire.loads(jax_wire.dumps(arr)), arr)


# ---------------------------------------------------------------------------
# ids and the object store's blob layout
# ---------------------------------------------------------------------------


def test_ids_match_the_jax_ids():
    for jcls, pcls in ((jax_ids.JobID, ids.JobID), (jax_ids.TaskID, ids.TaskID),
                       (jax_ids.ObjectID, ids.ObjectID),
                       (jax_ids.ActorID, ids.ActorID),
                       (jax_ids.NodeID, ids.NodeID),
                       (jax_ids.WorkerID, ids.WorkerID),
                       (jax_ids.PlacementGroupID, ids.PlacementGroupID)):
        assert pcls.SIZE == jcls.SIZE, pcls
    job = ids.JobID.from_int(7)
    assert job.binary() == jax_ids.JobID.from_int(7).binary()
    task = ids.TaskID.of(job)
    assert task.job_id() == job
    obj = ids.ObjectID.for_task_return(task, 3)
    jobj = jax_ids.ObjectID.for_task_return(jax_ids.TaskID(task.binary()), 3)
    assert obj.binary() == jobj.binary()
    assert obj.task_id() == task and obj.return_index() == 3
    actor = ids.ActorID.of(job)
    assert actor.job_id() == job
    assert jax_ids.ActorID(actor.binary()).job_id().binary() == job.binary()


@pytest.mark.parametrize("sizes", [(), (1024,), (1500, 7, 70000)])
def test_pack_blob_and_plan_layout_byte_equal(sizes):
    rng = np.random.default_rng(0)
    inband = bytes(rng.integers(0, 256, 333, dtype=np.uint8))
    buffers = [memoryview(bytes(rng.integers(0, 256, n, dtype=np.uint8)))
               for n in sizes]
    assert object_store.pack_blob(inband, buffers) == \
        jax_store.pack_blob(inband, buffers)
    assert object_store.plan_layout(inband, buffers) == \
        jax_store.plan_layout(inband, buffers)
    got_inband, got_buffers = object_store.read_blob(
        jax_store.pack_blob(inband, buffers))
    assert bytes(got_inband) == inband
    assert [bytes(b) for b in got_buffers] == [bytes(b) for b in buffers]


# ---------------------------------------------------------------------------
# the object serializer: tensors and by-value functions and classes
# ---------------------------------------------------------------------------


def _round_trip(value):
    inband, buffers = serialization.serialize(value)
    # through the store's blob layout, as a put and a get take it
    inband, buffers = object_store.read_blob(
        object_store.pack_blob(inband, buffers))
    return serialization.deserialize(inband, buffers)


@pytest.mark.parametrize("case", ["fp32", "bf16", "transposed", "strided",
                                  "scalar", "empty", "bool", "int64",
                                  "parameter"])
def test_tensor_round_trips(case):
    g = torch.Generator().manual_seed(0)
    x = {"fp32": lambda: torch.randn(37, 129, generator=g),
         "bf16": lambda: torch.randn(300, 70, generator=g).bfloat16(),
         "transposed": lambda: torch.randn(64, 48, 3, generator=g)
         .permute(2, 0, 1),
         "strided": lambda: torch.randn(40, 64, generator=g)[::3, 1::2],
         "scalar": lambda: torch.tensor(2.5, dtype=torch.float64),
         "empty": lambda: torch.empty(0, 5, dtype=torch.bfloat16),
         "bool": lambda: torch.randn(999, generator=g) > 0,
         "int64": lambda: torch.arange(5000).reshape(50, 100)[:, ::7],
         "parameter": lambda: torch.nn.Parameter(torch.randn(3, 4,
                                                             generator=g)),
         }[case]()
    got = _round_trip({"t": x, "rest": [1, "a"]})["t"]
    assert type(got) is type(x)
    assert got.dtype == x.dtype and got.shape == x.shape
    assert got.device.type == "cpu"
    assert torch.equal(got.detach(), x.detach())
    assert got.requires_grad == x.requires_grad
    if case == "transposed":  # a dense layout keeps its strides
        assert got.stride() == x.stride()


def test_tensor_crosses_as_one_out_of_band_buffer():
    x = torch.randn(256, 256).bfloat16()
    inband, buffers = serialization.serialize(x)
    assert len(buffers) == 1 and buffers[0].nbytes == x.numel() * 2
    assert len(inband) < 400


def test_checkpoint_blobs_keep_the_numpy_conversion():
    from ray_tpu._private.serialization import loads_oob as jax_loads_oob

    x = torch.randn(100, 30)
    got = jax_loads_oob(serialization.dumps_oob(x))
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, x.numpy())


_BLOCK = ("import sys\n"
          "for _m in ('cloudpickle', 'msgpack', 'psutil', 'boto3', 'jax',"
          " 'ray_tpu'):\n"
          "    sys.modules[_m] = None\n")

_PRODUCER = _BLOCK + textwrap.dedent("""
    from ray_tpu_torch._private import serialization

    SCALE = 3

    def outer(k):
        def fact(n):
            return 1 if n <= 1 else n * fact(n - 1)

        add = lambda x: x + k + SCALE

        class Local:
            base = 10

            def __init__(self, v):
                self.v = v

            def total(self):
                return self.v + self.base + k

            @staticmethod
            def tag():
                return "static"

            @classmethod
            def kind(cls):
                return cls.__name__

            @property
            def double(self):
                return 2 * self.v

        class Sub(Local):
            def total(self):
                return super().total() * 2

        return fact, add, Local, Sub

    def even(n):
        return n == 0 or odd(n - 1)

    def odd(n):
        return n != 0 and even(n - 1)

    fact, add, Local, Sub = outer(5)
    blob = serialization.dumps((fact, add, Local, Sub, Sub(1), even))
    sys.stdout.buffer.write(blob)
""")

_CONSUMER = _BLOCK + textwrap.dedent("""
    from ray_tpu_torch._private import serialization

    fact, add, Local, Sub, sub1, even = serialization.loads_trusted(
        sys.stdin.buffer.read())
    print(fact(6), add(1), Local(2).total(), Sub(2).total(), sub1.total(),
          Local.tag(), Sub.kind(), Local(4).double, even(10), even(7),
          isinstance(sub1, Local), "torch" in sys.modules)
""")


def test_by_value_pickler_without_cloudpickle():
    """Functions and classes that no module can name (``__main__``,
    ``<locals>``, lambdas, recursion, mutual recursion through globals,
    subclasses using ``super()``) cross to a fresh process with
    ``cloudpickle`` and ``msgpack`` blocked in both; neither loads torch."""
    env = dict(os.environ, PYTHONPATH=REPO)
    blob = subprocess.run([sys.executable, "-c", _PRODUCER], env=env,
                          capture_output=True, timeout=60, check=True).stdout
    out = subprocess.run([sys.executable, "-c", _CONSUMER], env=env,
                         input=blob, capture_output=True, timeout=60)
    assert out.returncode == 0, out.stderr.decode()
    assert out.stdout.decode().split() == [
        "720", "9", "17", "34", "32", "static", "Sub", "8", "True", "False",
        "True", "False"]


def test_importable_functions_travel_by_name():
    blob = serialization.dumps(accelerators.detect_gpus)
    assert b"detect_gpus" in blob and len(blob) < 120
    assert serialization.loads_trusted(blob) is accelerators.detect_gpus


# ---------------------------------------------------------------------------
# GPU detection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env,cards,want", [
    ({"RAY_TPU_TORCH_GPUS": "2"}, None, 2),
    ({"RAY_TPU_TORCH_GPUS": "0,3,5", "CUDA_VISIBLE_DEVICES": "0"}, 8, 3),
    ({"CUDA_VISIBLE_DEVICES": "0,1"}, None, 2),
    ({"CUDA_VISIBLE_DEVICES": "1"}, ["NVIDIA H100 80GB HBM3"] * 2, 1),
    ({"CUDA_VISIBLE_DEVICES": "0"}, ["NVIDIA H100 80GB HBM3"] * 2, 1),
    ({"CUDA_VISIBLE_DEVICES": "2"}, 8, 1),
    ({"CUDA_VISIBLE_DEVICES": ""}, ["NVIDIA H100 80GB HBM3"], 0),
    ({"CUDA_VISIBLE_DEVICES": "-1"}, None, 0),
    ({}, ["NVIDIA H100 80GB HBM3"] * 4, 4),
    ({}, None, 0),
])
def test_gpu_detection_from_the_environment(monkeypatch, env, cards, want):
    for key in ("RAY_TPU_TORCH_GPUS", "CUDA_VISIBLE_DEVICES"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    if isinstance(cards, int):
        cards = ["card"] * cards
    monkeypatch.setattr(accelerators, "_nvidia_smi_names", lambda: cards)
    got, labels = accelerators.detect_gpus()
    assert got == want
    if want and cards and "RAY_TPU_TORCH_GPUS" not in env:
        assert labels == {common.LABEL_ACCELERATOR_TYPE: cards[0]}
    else:
        assert labels == {}


@pytest.mark.parametrize("env,cards,want", [
    ({"RAY_TPU_TORCH_GPUS": "2"}, None, ["0", "1"]),
    ({"RAY_TPU_TORCH_GPUS": "0,3,5"}, 8, ["0", "3", "5"]),
    ({"CUDA_VISIBLE_DEVICES": "2"}, 8, ["2"]),
    ({"CUDA_VISIBLE_DEVICES": "3,1,-1,2"}, 8, ["3", "1"]),
    ({"CUDA_VISIBLE_DEVICES": "GPU-1234"}, 1, ["GPU-1234"]),
    ({"CUDA_VISIBLE_DEVICES": "0,1,2"}, 2, ["0", "1"]),
    ({}, 3, ["0", "1", "2"]),
])
def test_gpu_ids_are_what_cuda_visible_devices_takes(monkeypatch, env,
                                                     cards, want):
    """The ids the raylet binds leases to: a worker shown ``id`` alone
    through ``CUDA_VISIBLE_DEVICES`` sees that card."""
    for key in ("RAY_TPU_TORCH_GPUS", "CUDA_VISIBLE_DEVICES"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(accelerators, "_nvidia_smi_names",
                        lambda: None if cards is None else ["card"] * cards)
    assert accelerators.detect_gpu_ids()[0] == want


def test_runtime_env_cache_lies_apart_from_the_jax_runtimes():
    """Venvs and extracted packages are keyed by content alone, so the
    port keeps its own cache, under the temporary directory."""
    from ray_tpu._private import runtime_env as jax_renv
    from ray_tpu_torch._private import runtime_env as port_renv

    root = port_renv._CACHE_ROOT
    assert root != jax_renv._CACHE_ROOT
    assert not root.startswith(jax_renv._CACHE_ROOT + os.sep)
    assert os.path.dirname(root) == tempfile.gettempdir()


def test_nvidia_smi_lines_parse(monkeypatch, tmp_path):
    fake = tmp_path / "nvidia-smi"
    fake.write_text("#!/bin/sh\necho 'GPU 0: NVIDIA H100 80GB HBM3 "
                    "(UUID: GPU-1234)'\necho 'GPU 1: NVIDIA H100 80GB HBM3 "
                    "(UUID: GPU-5678)'\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    assert accelerators._nvidia_smi_names() == ["NVIDIA H100 80GB HBM3"] * 2


def test_gpu_resource_counts_into_requirements():
    assert common.TaskOptions(num_cpus=1, num_gpus=0.5).required_resources() \
        == {"CPU": 1.0, "GPU": 0.5}
    assert "num_tpus" not in common.TaskOptions.__dataclass_fields__


def test_observability_resets_after_fork():
    """What a worker forked from the zygote inherits is dropped: metric
    values (the instruments stay registered), spans and the goodput
    ledger."""
    from ray_tpu_torch.util import goodput, metrics, tracing

    c = metrics.Counter("ray_tpu_torch_test_fork_reset")
    c.inc(2)
    assert metrics.scrape_metrics()["ray_tpu_torch_test_fork_reset"][
        "data"] != {}
    with tracing._lock:  # a span as a traced zygote would hold one
        tracing._buffer.append({"name": "fork.test", "ts": 0.0})
    token = tracing.set_context("t" * 32, "s" * 16)
    goodput.add("step_compute", 1.5)
    metrics.reset_after_fork()
    tracing.reset_after_fork()
    goodput.reset_after_fork()
    assert metrics.scrape_metrics()["ray_tpu_torch_test_fork_reset"][
        "data"] == {}
    assert not [s for s in tracing.get_spans() if s["name"] == "fork.test"]
    assert tracing.current_context() is None
    tracing.reset_context(token)
    assert goodput.snapshot()["buckets"]["step_compute"] == 0.0
