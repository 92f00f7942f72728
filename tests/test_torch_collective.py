"""The port's collective layer against the JAX package's, on the CPU.

- The codecs (``ray_tpu_torch/collective/quant.py``) against the numpy
  codecs of ``ray_tpu/collective/quant.py`` on the same inputs: int8 and
  fp8 codes and scales bit for bit, bf16 codes bit for bit where no NaN is
  encoded (the two libraries spell NaN in bf16 differently), decoded values
  equal.
- ``TorchGroup`` on one gloo world of 4 ranks, each a process of its own
  (``run_world``; the rendezvous is a ``file://`` store under the test's
  ``tmp_path``): every op against its numpy definition, exactly, and
  ``quantized_reduce_scatter_1d`` against the JAX package's
  ``quantized_psum_scatter_1d`` on a 4-device CPU mesh. The ranks import
  this module, so it loads torch, numpy and the port only: the JAX
  package is imported inside the tests that hold the port against it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ray_tpu_torch.collective import quant
from ray_tpu_torch.collective.quant import ErrorFeedback, QuantCodec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
# quantized reduce-scatter: the lengths of tests/test_quant_comms.py (block
# aligned and ragged), block 64
QRS_BLOCK = 64
QRS_LENGTHS = (WORLD * WORLD * QRS_BLOCK * 2, WORLD * WORLD * 3)


def run_world(module_file: str, fn: str, world: int, tmp_path,
              timeout: float = 120.0, **kwargs):
    """``fn(rank, world, store, **kwargs)`` of the module at ``module_file``
    on ``world`` ranks, each a fresh Python process with one thread;
    ``store`` is a path for a ``file://`` rendezvous. Returns each rank's
    return value (saved with ``torch.save``), in rank order; raises with
    the ranks' stderr if any failed or ``timeout`` passed."""
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(world)]
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = []
    for rank in range(world):
        code = (
            "import importlib.util, sys, torch\n"
            "torch.set_num_threads(1)\n"
            f"sys.path[:0] = [{REPO!r}, {os.path.dirname(module_file)!r}]\n"
            "spec = importlib.util.spec_from_file_location('_rank', "
            f"{module_file!r})\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            f"out = mod.{fn}({rank}, {world}, {store!r}, **{kwargs!r})\n"
            f"torch.save(out, {outs[rank]!r})\n")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    try:
        for rank, proc in enumerate(procs):
            _, err = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                errors.append(f"rank {rank} exited {proc.returncode}:\n"
                              f"{err[-3000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    if errors:
        raise AssertionError("\n".join(errors))
    return [torch.load(path) for path in outs]


def _np_quant():
    # the JAX reference; the card's machine lacks flax
    pytest.importorskip("flax")
    from ray_tpu.collective import quant as np_quant

    return np_quant


def _same_codes(ours, theirs) -> None:
    np.testing.assert_array_equal(ours.codes.numpy(), theirs.codes)
    np.testing.assert_array_equal(ours.scales.numpy(), theirs.scales)


# -- codecs ------------------------------------------------------------------


@pytest.mark.parametrize("name,tol", [("int8", 0.01), ("fp8", 0.06),
                                      ("bf16", 0.01)])
@pytest.mark.parametrize("n", [1, 7, 63, 64, 65, 255, 256, 257, 1000])
def test_codec_matches_numpy_across_block_boundaries(name, tol, n):
    """tests/test_quant_comms.py's round trip at every block boundary, and
    the encoding itself equal to the numpy codec's, bit for bit."""
    np_quant = _np_quant()
    rng = np.random.default_rng(n)
    x = (rng.normal(size=n) * 10).astype(np.float32)
    qt = quant.quantize(torch.from_numpy(x), QuantCodec(name, 64))
    ref = np_quant.quantize(x, np_quant.QuantCodec(name, 64))
    _same_codes(qt, ref)
    y = quant.dequantize(qt)
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_array_equal(y.numpy(), np_quant.dequantize(ref))
    assert torch.isfinite(qt.scales).all()
    assert np.abs(y.numpy() - x).max() <= tol * np.abs(x).max()
    if name != "bf16":
        assert qt.codes.numel() == n and qt.scales.numel() == -(-n // 64)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(3, 5), (2, 3, 4), ()])
def test_codec_shapes_and_dtypes(shape, dtype):
    np_quant = _np_quant()
    rng = np.random.default_rng(0)
    x = np.asarray(rng.normal(size=shape) * 5, dtype=dtype)
    qt = quant.quantize(torch.from_numpy(x), QuantCodec("int8", 32))
    ref = np_quant.quantize(x, np_quant.QuantCodec("int8", 32))
    _same_codes(qt, ref)
    y = quant.dequantize(qt)
    assert tuple(y.shape) == shape and str(y.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(y.numpy(), np_quant.dequantize(ref))


@pytest.mark.parametrize("name", ["int8", "fp8", "bf16"])
def test_codec_nonfinite_inputs(name):
    """NaN encodes as 0 and ±inf saturates to the block's finite amax; the
    scales stay finite. A block of only non-finite values and zeros takes
    the numpy codec's scale too."""
    np_quant = _np_quant()
    x = np.array([1.0, np.nan, np.inf, -np.inf, 2.0, -3.0, 0.5, 0.0,
                  np.inf, np.nan, 0.0, -np.inf], np.float32)
    qt = quant.quantize(torch.from_numpy(x), QuantCodec(name, 4))
    ref = np_quant.quantize(x, np_quant.QuantCodec(name, 4))
    y = quant.dequantize(qt).numpy()
    np.testing.assert_array_equal(y, np_quant.dequantize(ref))
    if name == "bf16":
        return  # a narrowing: NaN and inf pass through (compared above)
    _same_codes(qt, ref)
    assert np.isfinite(qt.scales.numpy()).all() and np.isfinite(y).all()
    # e4m3 keeps 3 mantissa bits: a value rounds by up to 2^-4 of itself
    tol = {"int8": 0.05, "fp8": 2.0 ** -4 * 2.0}[name]
    assert y[1] == 0.0 and abs(y[0] - 1.0) < tol and abs(y[4] - 2.0) <= tol


@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_codec_zeros_roundtrip_exact(name):
    qt = quant.quantize(torch.zeros(130), QuantCodec(name, 64))
    assert torch.equal(qt.scales, torch.ones(3))  # zero blocks: scale 1
    assert torch.equal(quant.dequantize(qt), torch.zeros(130))


def test_encode_decode_single_buffer_form():
    np_quant = _np_quant()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(33, 7)).astype(np.float32)
    wire, meta = quant.encode_array(torch.from_numpy(x), QuantCodec("int8",
                                                                    32))
    ref_wire, ref_meta = np_quant.encode_array(x, np_quant.QuantCodec("int8",
                                                                      32))
    assert wire.dtype == torch.uint8 and wire.dim() == 1
    np.testing.assert_array_equal(wire.numpy(), ref_wire)
    assert {k: v for k, v in meta.items() if k != "dtype"} == \
        {k: v for k, v in ref_meta.items() if k != "dtype"}
    np.testing.assert_array_equal(quant.decode_array(wire, meta).numpy(),
                                  np_quant.decode_array(ref_wire, ref_meta))


def test_resolve_codec_specs():
    assert quant.resolve_codec(None) is None
    assert quant.resolve_codec("none") is None
    assert quant.resolve_codec("fp32") is None
    c = quant.resolve_codec("int8:128")
    assert (c.name, c.block) == ("int8", 128)
    assert quant.resolve_codec("fp8").block == quant.DEFAULT_BLOCK
    assert quant.resolve_codec(c) is c
    with pytest.raises(ValueError):
        quant.resolve_codec("int4")
    with pytest.raises(TypeError):
        quant.resolve_codec(123)


def test_error_feedback_matches_numpy():
    """Ten steps of error feedback: every step's codes and scales equal
    the numpy ErrorFeedback's, and the residual norms agree to fp32's
    rounding of the norm."""
    np_quant = _np_quant()
    ours = ErrorFeedback(QuantCodec("int8", 64))
    ref = np_quant.ErrorFeedback(np_quant.QuantCodec("int8", 64))
    rng = np.random.default_rng(7)
    for _ in range(10):
        g = (rng.normal(size=1000) * 0.01).astype(np.float32)
        _same_codes(ours.encode("g", torch.from_numpy(g)),
                    ref.encode("g", g))
        np.testing.assert_allclose(ours.residual_norm("g"),
                                   ref.residual_norm("g"), rtol=1e-5)
    ours.reset()
    assert ours.residual_norm("g") == 0.0


def test_reduce_wire_payloads_matches_numpy():
    """The reduce point: decode, sum in fp32 in rank order, encode once;
    the extra vector summed exactly."""
    np_quant = _np_quant()
    rng = np.random.default_rng(11)
    xs = [(rng.normal(size=300) * (r + 1)).astype(np.float32)
          for r in range(3)]
    extra = [np.array([r, 2.0 * r], np.float32) for r in range(3)]
    ours = quant.reduce_wire_payloads(
        [quant.to_wire(quant.quantize(torch.from_numpy(x),
                                      QuantCodec("fp8", 64)),
                       extra=torch.from_numpy(e)) for x, e in zip(xs, extra)],
        "fp8:64")
    ref = np_quant.reduce_wire_payloads(
        [np_quant.to_wire(np_quant.quantize(x, np_quant.QuantCodec("fp8",
                                                                   64)),
                          extra=e) for x, e in zip(xs, extra)], "fp8:64")
    np.testing.assert_array_equal(ours["codes"].numpy(), ref["codes"])
    np.testing.assert_array_equal(ours["scales"].numpy(), ref["scales"])
    np.testing.assert_array_equal(ours["extra"].numpy(), ref["extra"])
    assert quant.wire_nbytes(ours) == np_quant.wire_nbytes(ref)


def test_wire_bytes_accounting():
    np_quant = _np_quant()
    for codec in (None, "int8", "fp8:128", "bf16"):
        ours = quant.resolve_codec(codec)
        ref = np_quant.resolve_codec(codec)
        assert quant.reduce_scatter_wire_bytes(1 << 20, WORLD, ours) == \
            np_quant.xla_wire_bytes(1 << 20, WORLD, ref)
    assert QuantCodec("int8").bytes_per_element == \
        np_quant.QuantCodec("int8").bytes_per_element


# -- the group on gloo --------------------------------------------------------


def _contribution(rank: int) -> torch.Tensor:
    """Rank r's tensor: small integers (exact under every reduction,
    PRODUCT included), 2 * WORLD rows so that every op can tile axis 0."""
    gen = torch.Generator().manual_seed(100 + rank)
    return torch.randint(-3, 4, (2 * WORLD, 3), generator=gen).float()


def _qrs_input(length: int) -> np.ndarray:
    return np.random.default_rng(length).normal(size=length).astype(
        np.float32)


def group_rank(rank: int, world: int, store: str) -> dict:
    """One rank's run of every ``TorchGroup`` op (what ``run_world`` calls
    in each process)."""
    from ray_tpu_torch import collective as col
    from ray_tpu_torch.collective import ReduceOp

    group = col.init_collective_group(world, rank, backend="cpu",
                                      group_name="g", device="cpu",
                                      init_method=f"file://{store}")
    out = {"rank": col.get_rank("g"),
           "size": col.get_collective_group_size("g"),
           "backend": group.backend}
    x = _contribution(rank)
    for op in ReduceOp:
        out[f"allreduce_{op.name}"] = col.allreduce(x, op, group_name="g")
        out[f"reducescatter_{op.name}"] = col.reducescatter(x, op,
                                                            group_name="g")
        out[f"reduce_{op.name}"] = col.reduce(x, 1, op, group_name="g")
    out["allgather"] = col.allgather(x[:3], group_name="g")
    out["alltoall"] = col.alltoall(x, group_name="g")
    out["broadcast"] = col.broadcast(x, 2, group_name="g")
    out["ppermute_ring"] = group.ppermute(
        x, [(i, (i + 1) % world) for i in range(world)])
    out["ppermute_partial"] = group.ppermute(x, [(0, 2), (1, 1)])
    if rank == 0:
        col.send(torch.full((2, 3), 1.5, dtype=torch.bfloat16), 3,
                 group_name="g", tag=7)
    if rank == 3:
        out["recv"] = col.recv(0, group_name="g", tag=7)
    if rank == 1:
        col.send(torch.arange(5), 2, group_name="g")
    if rank == 2:
        out["recv"] = col.recv(1, group_name="g")
    col.barrier(group_name="g")
    errors = {}
    for what, call in (
            ("tiles", lambda: col.reducescatter(x[:3], group_name="g")),
            ("device", lambda: col.allreduce(torch.empty(2, device="meta"),
                                             group_name="g")),
            ("twice", lambda: col.init_collective_group(
                world, rank, group_name="g", device="cpu"))):
        try:
            call()
        except ValueError as e:
            errors[what] = str(e)
    out["errors"] = errors
    for name in ("int8", "fp8", "bf16"):
        fn = quant.quantized_reduce_scatter_1d(group, QuantCodec(name,
                                                                 QRS_BLOCK))
        for length in QRS_LENGTHS:
            local = length // world
            x_all = torch.from_numpy(_qrs_input(length))
            out[f"qrs_{name}_{length}"] = fn(
                x_all[rank * local:(rank + 1) * local])
    wire = quant.to_wire(quant.quantize(x.reshape(-1) * (rank + 1),
                                        QuantCodec("int8", 8)),
                         extra=torch.tensor([float(rank)]))
    out["allreduce_quantized"] = col.allreduce_quantized(
        wire, QuantCodec("int8", 8), group_name="g")
    col.destroy_collective_group("g")
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's results of ``group_rank`` (one gloo world of 4)."""
    return run_world(os.path.abspath(__file__), "group_rank", WORLD,
                     tmp_path_factory.mktemp("gloo4"))


def _reduce_np(stack: np.ndarray, op: str) -> np.ndarray:
    return {"SUM": stack.sum(0), "PRODUCT": stack.prod(0),
            "MIN": stack.min(0), "MAX": stack.max(0),
            "AVERAGE": stack.mean(0)}[op]


OPS = ("SUM", "PRODUCT", "MIN", "MAX", "AVERAGE")
ALL = np.stack([_contribution(r).numpy() for r in range(WORLD)])


def test_group_bookkeeping(world):
    assert [o["rank"] for o in world] == list(range(WORLD))
    assert all(o["size"] == WORLD and o["backend"] == "gloo" for o in world)
    for o in world:
        assert set(o["errors"]) == {"tiles", "device", "twice"}


@pytest.mark.parametrize("op", OPS)
def test_allreduce(world, op):
    want = _reduce_np(ALL, op)
    for o in world:
        np.testing.assert_array_equal(o[f"allreduce_{op}"].numpy(), want)


@pytest.mark.parametrize("op", OPS)
def test_reducescatter_tiles_axis0(world, op):
    tiles = np.split(_reduce_np(ALL, op), WORLD, axis=0)
    for r, o in enumerate(world):
        np.testing.assert_array_equal(o[f"reducescatter_{op}"].numpy(),
                                      tiles[r])


@pytest.mark.parametrize("op", OPS)
def test_reduce_to_one_rank(world, op):
    for r, o in enumerate(world):
        want = _reduce_np(ALL, op) if r == 1 else ALL[r]
        np.testing.assert_array_equal(o[f"reduce_{op}"].numpy(), want)


def test_allgather_alltoall_broadcast(world):
    gathered = np.concatenate([ALL[r][:3] for r in range(WORLD)])
    tiles = [np.split(ALL[r], WORLD, axis=0) for r in range(WORLD)]
    for r, o in enumerate(world):
        np.testing.assert_array_equal(o["allgather"].numpy(), gathered)
        np.testing.assert_array_equal(
            o["alltoall"].numpy(),
            np.concatenate([tiles[src][r] for src in range(WORLD)]))
        np.testing.assert_array_equal(o["broadcast"].numpy(), ALL[2])


def test_ppermute(world):
    for r, o in enumerate(world):
        np.testing.assert_array_equal(o["ppermute_ring"].numpy(),
                                      ALL[(r - 1) % WORLD])
        want = {2: ALL[0], 1: ALL[1]}.get(r, np.zeros_like(ALL[0]))
        np.testing.assert_array_equal(o["ppermute_partial"].numpy(), want)


def test_send_recv_carry_dtype_and_shape(world):
    got = world[3]["recv"]
    assert got.dtype == torch.bfloat16 and torch.equal(
        got, torch.full((2, 3), 1.5, dtype=torch.bfloat16))
    assert torch.equal(world[2]["recv"], torch.arange(5))


def _np_reduce_scatter(np_quant, name: str, length: int):
    """The reduce-scatter by the numpy codec: rank r's segment j (of the
    vector split over WORLD ranks, then over WORLD owners) encoded on its
    own, decoded, and the segments summed over r in rank order in fp32.
    Returns the owners' sums end to end, and the sum of |decoded| (for
    the bound against the JAX program)."""
    x = _qrs_input(length).reshape(WORLD, WORLD, -1)  # (rank, owner, seg)
    codec = np_quant.QuantCodec(name, QRS_BLOCK)
    dec = np.stack([[np_quant.dequantize(np_quant.quantize(x[r, j], codec))
                     for j in range(WORLD)] for r in range(WORLD)])
    total = dec[0]
    for r in range(1, WORLD):
        total = total + dec[r]
    return total.reshape(-1), np.abs(dec).sum(0).reshape(-1)


@pytest.mark.parametrize("name", ["int8", "fp8", "bf16"])
def test_quantized_reduce_scatter_is_the_codec_sum(world, name):
    """Each owner's segment is the rank-ordered fp32 sum of the numpy
    codec's decodings, bit for bit."""
    np_quant = _np_quant()
    for length in QRS_LENGTHS:
        got = np.concatenate([o[f"qrs_{name}_{length}"].numpy()
                              for o in world])
        want, _ = _np_reduce_scatter(np_quant, name, length)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["int8", "fp8", "bf16"])
def test_quantized_reduce_scatter_matches_jax(world, name):
    """Against ``quantized_psum_scatter_1d`` on a 4-device CPU mesh, fed
    the same vector. The codes agree, but not bit for bit in the sum: XLA
    computes the jitted encoder's ``amax / 127`` (and ``/ 448``) as a
    product with the rounded reciprocal, so a scale can part from the
    numpy codec's (and the port's) by up to 2^-22 of itself, and XLA may
    fuse or reorder the decode-and-sum, up to WORLD roundings of 2^-24 of
    the running sum. Per element: |got - want| <= (2^-22 + WORLD * 2^-24)
    * sum_r |decoded_r|. bf16 carries no scale and agrees bit for bit."""
    _np_quant()
    import jax
    from jax.sharding import Mesh

    from ray_tpu.collective import quant as jax_quant

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    fn = jax_quant.quantized_psum_scatter_1d(
        mesh, "data", jax_quant.QuantCodec(name, QRS_BLOCK))
    for length in QRS_LENGTHS:
        want = np.asarray(fn(_qrs_input(length)))
        got = np.concatenate([o[f"qrs_{name}_{length}"].numpy()
                              for o in world])
        assert got.shape == want.shape == (length // WORLD,)
        _, mag = _np_reduce_scatter(jax_quant, name, length)
        bound = (2.0 ** -22 + WORLD * 2.0 ** -24) * mag
        assert np.all(np.abs(got - want) <= bound), \
            np.abs(got - want).max()
        if name == "bf16":
            np.testing.assert_array_equal(got, want)


def test_allreduce_quantized_matches_store_reduce(world):
    """Every rank gets the encoded sum the JAX package's store computes
    (``reduce_wire_payloads`` of the numpy encodings)."""
    np_quant = _np_quant()
    payloads = [np_quant.to_wire(
        np_quant.quantize(ALL[r].reshape(-1) * (r + 1),
                          np_quant.QuantCodec("int8", 8)),
        extra=np.array([r], np.float32)) for r in range(WORLD)]
    ref = np_quant.reduce_wire_payloads(payloads, "int8:8")
    for o in world:
        got = o["allreduce_quantized"]
        np.testing.assert_array_equal(got["codes"].numpy(), ref["codes"])
        np.testing.assert_array_equal(got["scales"].numpy(), ref["scales"])
        np.testing.assert_array_equal(got["extra"].numpy(), ref["extra"])


def test_backend_follows_device():
    from ray_tpu_torch.collective import Backend, init_collective_group

    assert Backend.validate("xla") == "nccl"
    assert Backend.validate("cpu") == "gloo"
    assert Backend.for_device("cuda") == "nccl"
    with pytest.raises(ValueError):
        Backend.validate("mpi")
    if not torch.cuda.is_available():
        # the card is the default, and its absence is an error, not the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_collective_group(1, 0, group_name="nocard")
    with pytest.raises(ValueError, match="does not run on"):
        init_collective_group(1, 0, backend="nccl", group_name="mismatch",
                              device="cpu")
