"""The port's channel plane (``ray_tpu_torch/dag/channels.py``) on the CPU: a
mirror of ``tests/test_channels.py`` with torch tensors (bf16 among them)
in place of jax arrays.

Covers:
(a) tensor-aware zero-copy framing round trips — dtypes, nested trees,
    0-d / empty / non-contiguous tensors and arrays, inline non-array
    leaves, quantized activation streaming (int8 codes + exact non-float
    leaves, decoded as the JAX channel decodes the same values),
(b) ring-depth semantics: ``depth`` writes run ahead of the reader, the
    next write blocks on the ack of value ``n - depth``, and both sides'
    TimeoutErrors carry the version/ack state of the wedged slot,
(c) torn-read safety: a crashed writer (killed mid-slot) never presents a
    torn even version, and a reader that outlives the writer times out
    with diagnostics instead of decoding garbage,
(d) crash-restart attach: both endpoints derive their resume sequences
    from the shm state,
(e) gang re-form hygiene: ``channel_shm_paths`` covers every ring any
    rank opens (V=1 chain and V>1 full ring),
(f) cross-host leg: the writer's bounded retry + the mailbox's sequence
    dedup never double-deliver a value.
"""

import collections
import os
import signal
import subprocess
import sys
import time
import uuid

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.dag.channels import SHM_PREFIX, Channel


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _ring(name=None, **kw):
    name = name or f"tch_{uuid.uuid4().hex[:8]}"
    kw.setdefault("capacity", 1 << 16)
    writer = Channel(name, create=True, **kw)
    reader = Channel(name, reader_slot=0)
    return name, writer, reader


def _roundtrip(writer, reader, value):
    writer.write(value, timeout=10)
    return reader.read(timeout=10)


def _flatten(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _flatten(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for item in x for v in _flatten(item)]
    return [x]


Point = collections.namedtuple("Point", "x y")


# ---------------------------------------------------------------------------
# (a) zero-copy framing round trips
# ---------------------------------------------------------------------------


def test_zero_copy_roundtrip_dtypes_and_trees():
    _, w, r = _ring(depth=2)
    base = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    cases = [
        base,
        torch.tensor(3.25, dtype=torch.float64),          # 0-d
        torch.zeros((0, 5), dtype=torch.int32),           # empty
        torch.arange(10, dtype=torch.int64)[::2],         # non-contiguous
        base.T,                                           # transposed view
        torch.tensor([True, False, True]),
        np.arange(10, dtype=np.int64)[::2],               # numpy leaves too
        np.zeros((), np.float64),
        {"a": base, "b": [torch.full((3,), 7, dtype=torch.uint8), "text"],
         "c": (1, 2.5, None), "p": Point(torch.ones(2), "tag"),
         "n": np.ones((2, 3), np.float16)},
        {"scalars": 42, "s": "inline-only", "t": (1, [2, 3])},
    ]
    try:
        for value in cases:
            got = _roundtrip(w, r, value)
            flat_w, flat_g = _flatten(value), _flatten(got)
            assert len(flat_w) == len(flat_g)
            for a, b in zip(flat_w, flat_g):
                if isinstance(a, torch.Tensor):
                    assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
                    assert a.dtype == b.dtype and a.shape == b.shape
                    assert torch.equal(a, b)
                elif isinstance(a, np.ndarray):
                    assert isinstance(b, np.ndarray)
                    assert a.dtype == b.dtype and a.shape == b.shape
                    np.testing.assert_array_equal(a, b)
                else:
                    assert a == b or (a is None and b is None)
        # namedtuple type survives the skeleton
        got = _roundtrip(w, r, Point(torch.ones(2), 5))
        assert type(got).__name__ == "Point" and got.y == 5
    finally:
        w.close(unlink=True)
        r.close()


def test_zero_copy_roundtrip_tensors_and_bf16():
    _, w, r = _ring(depth=1)
    try:
        y = torch.randn(3, 5).to(torch.bfloat16)
        tree = {"x": torch.arange(16, dtype=torch.float32).reshape(4, 4),
                "y": y, "mb": 3}
        got = _roundtrip(w, r, tree)
        assert torch.equal(got["x"], tree["x"])
        # bf16 has no numpy dtype: its raw bytes cross with torch's name
        assert got["y"].dtype == torch.bfloat16
        assert torch.equal(got["y"].view(torch.int16), y.view(torch.int16))
        assert got["mb"] == 3
        # the hot path reports real stats: one frame, no pickle of tensors
        assert w.last_write_stats["wire_bytes"] == \
            r.last_read_stats["wire_bytes"] > 0
        assert w.last_write_stats["skel_bytes"] < 1024
    finally:
        w.close(unlink=True)
        r.close()


def test_quantized_activation_streaming_int8():
    _, w, r = _ring(depth=1, capacity=1 << 16)
    try:
        w.set_codec("int8")
        f = torch.linspace(-4.0, 4.0, 512).reshape(8, 64)
        tree = {"act": f, "mask": torch.ones(8, dtype=torch.int32), "mb": 1}
        w.write(tree, timeout=10)
        wire_q = w.last_write_stats["wire_bytes"]
        got = r.read(timeout=10)
        # float leaf: approximate (block-scaled int8), int leaf: exact
        assert (got["act"] - f).abs().max().item() < 0.05
        assert torch.equal(got["mask"], tree["mask"])
        assert got["mb"] == 1
        # the same values through the JAX channel's int8 codec
        pytest.importorskip("flax")
        from ray_tpu.dag.channels import Channel as JaxChannel

        jname = f"tchj_{uuid.uuid4().hex[:8]}"
        jw = JaxChannel(jname, capacity=1 << 16, create=True)
        jr = JaxChannel(jname, reader_slot=0)
        try:
            jw.set_codec("int8")
            jw.write({"act": f.numpy()}, timeout=10)
            want = jr.read(timeout=10)["act"]
            np.testing.assert_array_equal(got["act"].numpy(), want)
        finally:
            jw.close(unlink=True)
            jr.close()
        # quantization actually shrank the wire footprint
        w.set_codec(None)
        w.write(tree, timeout=10)
        wire_exact = w.last_write_stats["wire_bytes"]
        got2 = r.read(timeout=10)
        assert torch.equal(got2["act"], f)
        assert wire_q < wire_exact
    finally:
        w.close(unlink=True)
        r.close()


# ---------------------------------------------------------------------------
# (b) ring depth + backpressure diagnostics
# ---------------------------------------------------------------------------


def test_ring_depth_overlap_and_backpressure():
    _, w, r = _ring(depth=2)
    try:
        # depth=2: two writes complete with no reader ack at all
        w.write({"v": 0}, timeout=5)
        w.write({"v": 1}, timeout=5)
        # the third blocks on the ack of value 0 (slot reuse)
        with pytest.raises(TimeoutError) as ei:
            w.write({"v": 2}, timeout=0.3)
        msg = str(ei.value)
        assert "acks=" in msg and "slot 0" in msg and "seq 0" in msg
        # draining frees the ring in FIFO order
        assert r.read(timeout=5)["v"] == 0
        w.write({"v": 2}, timeout=5)
        assert r.read(timeout=5)["v"] == 1
        assert r.read(timeout=5)["v"] == 2
    finally:
        w.close(unlink=True)
        r.close()


def test_reader_timeout_reports_slot_state():
    _, w, r = _ring(depth=2)
    try:
        with pytest.raises(TimeoutError) as ei:
            r.read(timeout=0.3)
        msg = str(ei.value)
        assert "version=" in msg and "want=" in msg and "acks=" in msg
    finally:
        w.close(unlink=True)
        r.close()


def test_crash_restart_attach_resumes_sequences():
    name, w, r = _ring(depth=2)
    try:
        for i in range(3):
            w.write({"v": torch.tensor(i)}, timeout=5)
            if i < 2:
                assert r.read(timeout=5)["v"].item() == i
        # both endpoints die (no unlink) and fresh processes re-attach
        w.close()
        r.close()
        w2 = Channel(name)               # writer attach: resumes at seq 3
        r2 = Channel(name, reader_slot=0)  # reader attach: resumes at seq 2
        assert w2._wseq == 3 and r2._rseq == 2
        assert r2.read(timeout=5)["v"].item() == 2
        w2.write({"v": torch.tensor(3)}, timeout=5)
        assert r2.read(timeout=5)["v"].item() == 3
    finally:
        Channel(name).close(unlink=True)


# ---------------------------------------------------------------------------
# (c) torn-read safety under writer crash
# ---------------------------------------------------------------------------

_CRASH_WRITER = r"""
import sys, torch
sys.path.insert(0, {repo!r})
from ray_tpu_torch.dag.channels import Channel

ch = Channel({name!r}, capacity=1 << 22, create=True, depth=2)
n = 0
while True:  # killed by SIGKILL mid-loop; large payload widens the window
    ch.write({{"seq": n, "data": torch.full((1 << 18,), n,
                                            dtype=torch.int64)}},
             timeout=60)
    n += 1
"""


def test_writer_killed_mid_slot_never_presents_torn_value(tmp_path):
    name = f"tch_crash_{uuid.uuid4().hex[:8]}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-c", _CRASH_WRITER.format(repo=repo, name=name)],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    path = f"/dev/shm/{SHM_PREFIX}{name}"
    try:
        deadline = time.time() + 60
        reader = None
        while reader is None and time.time() < deadline:
            try:  # the file can exist before the child seals the header
                reader = Channel(name, reader_slot=0)
            except (FileNotFoundError, RuntimeError, ValueError):
                time.sleep(0.05)
        assert reader is not None, "crash writer never created the ring"
        seen = -1
        for _ in range(8):  # healthy stream first: uniform, in order
            v = reader.read(timeout=30)
            data = v["data"]
            assert data.min() == data.max() == v["seq"], "torn value"
            assert v["seq"] == seen + 1
            seen = v["seq"]
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
        # drain whatever the dead writer sealed; every surviving value
        # must still be internally consistent — a torn (mid-copy) slot
        # must never present an even version to the reader
        try:
            while True:
                v = reader.read(timeout=0.5)
                data = v["data"]
                assert data.min() == data.max() == v["seq"], \
                    "reader decoded a torn slot after writer crash"
        except TimeoutError as e:
            assert "version=" in str(e)  # diagnostics survive the crash
        reader.close()
    finally:
        if proc.poll() is None:
            proc.kill()
        if os.path.exists(path):
            os.unlink(path)


def test_torn_header_is_not_trusted():
    """A sealed version with a garbage length/seq (emulated torn header)
    must never drive the payload copy — the reader keeps spinning."""
    import struct

    name, w, r = _ring(depth=1)
    try:
        w.write({"v": 1}, timeout=5)
        # corrupt the slot: bump seq so the snapshot validation fails
        base = w._slot_base(0)
        struct.pack_into("<Q", w.seg.buf, base + 16, 999)
        with pytest.raises(TimeoutError) as ei:
            r.read(timeout=0.3)
        assert "slot_seq=999" in str(ei.value)
        # restore the real seq: the same read now succeeds
        struct.pack_into("<Q", w.seg.buf, base + 16, 0)
        assert r.read(timeout=5)["v"] == 1
    finally:
        w.close(unlink=True)
        r.close()


# ---------------------------------------------------------------------------
# (e) gang re-form unlinks every ring generation
# ---------------------------------------------------------------------------


def test_channel_shm_paths_cover_all_rings():
    from ray_tpu_torch.train.pipeline.stage import (_chan_names,
                                                    channel_shm_paths)

    for S in (2, 3, 4):
        for V in (1, 2, 3):
            paths = set(channel_shm_paths("run", 0, S, V))
            opened = set()
            for s in range(S):
                names = _chan_names("run", 0, s, S, V)
                opened |= {f"/dev/shm/{SHM_PREFIX}{n}"
                           for n in names.values() if n}
            # every endpoint any rank opens is covered by the unlink sweep
            assert opened == paths, (S, V)
            # V=1 chain: S-1 edges per direction; V>1 ring: S per direction
            assert len(paths) == (2 * (S - 1) if V == 1 else 2 * S), (S, V)
    assert channel_shm_paths("run", 0, 1, 1) == []
    # generations never collide (re-formed gang gets fresh rings)
    assert not (set(channel_shm_paths("run", 0, 2, 2)) &
                set(channel_shm_paths("run", 1, 2, 2)))
    # nor with a JAX cluster's rings on the same host
    assert all(os.path.basename(p).startswith("rtpt_chan_")
               for p in channel_shm_paths("run", 0, 2, 2))


def test_gang_reform_unlink_sweeps_generations():
    from ray_tpu_torch.train.pipeline.stage import channel_shm_paths

    run = f"tgang_{uuid.uuid4().hex[:6]}"
    created = []
    for gen in (0, 1):
        for p in channel_shm_paths(run, gen, 2, 2):
            name = os.path.basename(p)[len(SHM_PREFIX):]
            Channel(name, capacity=1 << 12, create=True, depth=2).close()
            created.append(p)
    assert all(os.path.exists(p) for p in created)
    # the controller's kill path: unlink every generation's paths
    for gen in (0, 1):
        for p in channel_shm_paths(run, gen, 2, 2):
            if os.path.exists(p):
                os.unlink(p)
    assert not any(os.path.exists(p) for p in created)


# ---------------------------------------------------------------------------
# (f) cross-host writer: bounded retry + sequence dedup
# ---------------------------------------------------------------------------


def test_cross_host_retry_and_dedup(cluster):
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.dag.channels import CrossHostReader, CrossHostWriter

    w = worker_mod.global_worker()
    mbox = f"xch_{uuid.uuid4().hex[:8]}@0"
    writer = CrossHostWriter("xch_test", [(mbox, w.address)])
    reader = CrossHostReader(mbox)
    try:
        writer.write({"v": 0, "t": torch.ones(4, dtype=torch.bfloat16)})
        got = reader.read(timeout=10)
        assert got["v"] == 0 and got["t"].dtype == torch.bfloat16

        # transient RPC failure: the first attempt dies, the retry lands —
        # exactly one delivery
        real_client = w._worker_client
        fails = {"n": 1}

        class _Flaky:
            def __init__(self, inner):
                self._inner = inner

            async def call(self, method, payload, **kw):
                if method == "ChanPush" and fails["n"] > 0:
                    fails["n"] -= 1
                    raise ConnectionResetError("injected transient failure")
                return await self._inner.call(method, payload, **kw)

        w._worker_client = lambda addr: _Flaky(real_client(addr))
        try:
            writer.write({"v": 1})
        finally:
            w._worker_client = real_client
        assert fails["n"] == 0, "injected failure never fired"
        assert reader.read(timeout=10)["v"] == 1

        # ambiguous failure: the push LANDED but the ack was lost; the
        # writer's re-push of the same sequence must dedup at the mailbox
        seq_before = writer._seq
        writer.write({"v": 2})
        writer._seq = seq_before  # emulate the lost-ack retry
        writer.write({"v": 2})
        assert reader.read(timeout=10)["v"] == 2
        with pytest.raises(TimeoutError):
            reader.read(timeout=0.5)  # no double delivery
        # a NEW sequence after the dup flows normally
        writer._seq = seq_before + 1
        writer.write({"v": 3})
        assert reader.read(timeout=10)["v"] == 3
    finally:
        reader.close(unlink=True)
