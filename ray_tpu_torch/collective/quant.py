"""Block-quantized codecs on tensors: the port of
``ray_tpu/collective/quant.py``.

A quantized payload is ``(codes: uint8, scales: float32)`` over fixed-size
blocks of the flattened input, as in the JAX package:

- ``int8``: symmetric per-block scaling to [-127, 127], rounded half to
  even; 1 byte an element plus 4 bytes of scale a block.
- ``fp8``: e4m3 (``torch.float8_e4m3fn``): per-block scaling maps the
  block's amax to the e4m3 maximum (448), clamped before the cast so that
  the cast saturates instead of overflowing to NaN; 1 byte an element.
- ``bf16``: a plain narrowing to bfloat16, no scales; 2 bytes an element.

The codes and scales are the numpy codecs' bit for bit (the same fp32
divisions and roundings), on CPU or CUDA tensors alike. Non-finite inputs
follow the same rules: NaN encodes as 0, ±inf saturates to the block's
finite amax, and scales are always finite.

``quantized_reduce_scatter_1d`` is the counterpart of the JAX package's
``quantized_psum_scatter_1d``: quantize each owner's segment, exchange the
codes and scales with one all-to-all each, and dequantize-and-accumulate in
fp32 in rank order. None of this is a kernel in the reference (plain XLA
there), and it is plain PyTorch here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

FP8_MAX = 448.0  # torch.float8_e4m3fn's finite maximum
DEFAULT_BLOCK = 256

_CODEC_NAMES = ("int8", "fp8", "bf16")
_CODE_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


@dataclass(frozen=True)
class QuantCodec:
    """One codec choice: name and block size (the block is ignored for
    bf16)."""

    name: str
    block: int = DEFAULT_BLOCK

    def __post_init__(self):
        if self.name not in _CODEC_NAMES:
            raise ValueError(
                f"unknown codec {self.name!r} (one of {_CODEC_NAMES})")
        if self.block <= 0:
            raise ValueError(f"block must be positive, got {self.block}")

    @property
    def bytes_per_element(self) -> float:
        if self.name == "bf16":
            return 2.0
        return 1.0 + 4.0 / self.block  # the code and a share of the scale

    def spec(self) -> str:
        return f"{self.name}:{self.block}"


def resolve_codec(compression: Any) -> Optional[QuantCodec]:
    """A user-facing ``compression`` knob as a codec: None / "none" (off),
    "int8" / "fp8" / "bf16", an "int8:128"-style spec with a block size, or
    a ``QuantCodec``."""
    if compression is None:
        return None
    if isinstance(compression, QuantCodec):
        return compression
    if not isinstance(compression, str):
        raise TypeError(f"compression must be a string or QuantCodec, "
                        f"got {type(compression).__name__}")
    s = compression.strip().lower()
    if s in ("", "none", "off", "fp32"):
        return None
    if ":" in s:
        name, _, block = s.partition(":")
        return QuantCodec(name, int(block))
    return QuantCodec(s)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@dataclass
class QuantizedTensor:
    """One encoded tensor: flat uint8 codes and per-block fp32 scales, on
    the input's device. ``dtype`` names the input's dtype (``float32``)."""

    codec: str
    block: int
    shape: Tuple[int, ...]
    dtype: str
    codes: torch.Tensor  # uint8, one a value (two for bf16), tail unpadded
    scales: torch.Tensor  # float32, one a block (empty for bf16)

    @property
    def wire_nbytes(self) -> int:
        return self.codes.numel() + 4 * self.scales.numel()

    @property
    def raw_nbytes(self) -> int:
        itemsize = getattr(torch, self.dtype).itemsize
        return math.prod(self.shape) * itemsize

    def meta(self) -> Dict[str, Any]:
        return {"codec": self.codec, "block": self.block,
                "shape": list(self.shape), "dtype": self.dtype,
                "nscales": self.scales.numel()}


def block_encode(xb: torch.Tensor, codec_name: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode fp32 blocks ``(..., nblocks, block)``: ``(codes, scales)`` with
    codes int8 or float8_e4m3fn in ``xb``'s shape and scales ``(...,
    nblocks)``. NaN becomes 0 and ±inf the block's finite amax before the
    block's amax is taken, as the numpy codec does."""
    finite = torch.isfinite(xb)
    cap = torch.where(finite, xb, 0.0).abs().amax(dim=-1, keepdim=True)
    cap = torch.where(cap > 0, cap, 1.0)
    xb = torch.where(torch.isnan(xb), 0.0, torch.clamp(xb, -cap, cap))
    amax = xb.abs().amax(dim=-1)
    # the scale is amax / qmax rounded once, as numpy divides: a tensor
    # divisor, since CUDA divides by a Python number as a product with its
    # rounded reciprocal, which can part from the quotient by an ulp
    qmax = torch.full_like(amax, 127.0 if codec_name == "int8" else FP8_MAX)
    scales = torch.where(amax > 0, amax / qmax, 1.0)
    if codec_name == "int8":
        q = torch.clamp(torch.round(xb / scales[..., None]), -127, 127)
        return q.to(torch.int8), scales
    # fp8: clamp before the cast, which would turn values above the finite
    # maximum into NaN; the fp32 division can land one ulp above it
    q = torch.clamp(xb / scales[..., None], -FP8_MAX, FP8_MAX)
    return q.to(torch.float8_e4m3fn), scales


def quantize(x: torch.Tensor, codec: QuantCodec) -> QuantizedTensor:
    """Encode ``x`` (any shape, float dtype) into flat uint8 codes and
    scales on its device."""
    shape, dtype = tuple(x.shape), _dtype_name(x.dtype)
    if codec.name == "bf16":
        codes = x.to(torch.bfloat16).reshape(-1).view(torch.uint8)
        return QuantizedTensor(codec.name, codec.block, shape, dtype, codes,
                               x.new_zeros(0, dtype=torch.float32))
    flat = x.to(torch.float32).reshape(-1)
    n = flat.numel()
    nb = max(1, -(-n // codec.block))
    xb = torch.nn.functional.pad(flat, (0, nb * codec.block - n))
    q, scales = block_encode(xb.reshape(nb, codec.block), codec.name)
    # the ragged tail's padding never crosses the wire (decode re-pads)
    codes = q.reshape(-1).view(torch.uint8)[:n]
    return QuantizedTensor(codec.name, codec.block, shape, dtype, codes,
                           scales)


def dequantize(qt: QuantizedTensor) -> torch.Tensor:
    """Decode back to the original shape and dtype (lossy)."""
    n = math.prod(qt.shape)
    dtype = getattr(torch, qt.dtype)
    if qt.codec == "bf16":
        vals = qt.codes.view(torch.bfloat16).to(torch.float32)
        return vals[:n].reshape(qt.shape).to(dtype)
    nb = qt.scales.numel()
    codes = torch.nn.functional.pad(qt.codes, (0, nb * qt.block
                                               - qt.codes.numel()))
    q = codes.view(_CODE_DTYPES[qt.codec]).to(torch.float32)
    vals = (q.reshape(nb, -1) * qt.scales[:, None]).reshape(-1)
    return vals[:n].reshape(qt.shape).to(dtype)


# -- single-buffer form ------------------------------------------------------


def encode_array(x: torch.Tensor, codec: QuantCodec
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One flat uint8 buffer ``[scales fp32 | codes]`` and a JSON-safe meta
    dict (the JAX package's weight-chunk encoding)."""
    qt = quantize(x, codec)
    wire = torch.cat([qt.scales.view(torch.uint8), qt.codes])
    return wire, qt.meta()


def decode_array(wire: torch.Tensor, meta: Dict[str, Any]) -> torch.Tensor:
    wire = wire.reshape(-1)
    nscales = int(meta["nscales"])
    scales = wire[:nscales * 4].clone().view(torch.float32)
    codes = wire[nscales * 4:].clone()
    return dequantize(QuantizedTensor(
        meta["codec"], int(meta["block"]), tuple(meta["shape"]),
        meta["dtype"], codes, scales))


# -- the collective payload form ---------------------------------------------


def to_wire(qt: QuantizedTensor, extra: Optional[torch.Tensor] = None
            ) -> Dict[str, Any]:
    """``extra``: an optional small fp32 vector (metrics, control scalars)
    that rides the same exchange unquantized and is summed exactly."""
    d = {"codec": qt.codec, "block": qt.block, "shape": list(qt.shape),
         "dtype": qt.dtype, "codes": qt.codes, "scales": qt.scales}
    if extra is not None:
        d["extra"] = torch.as_tensor(extra, dtype=torch.float32)
    return d


def from_wire(d: Dict[str, Any]) -> QuantizedTensor:
    return QuantizedTensor(d["codec"], int(d["block"]), tuple(d["shape"]),
                           d["dtype"], d["codes"], d["scales"])


def wire_nbytes(d: Dict[str, Any]) -> int:
    return d["codes"].numel() + 4 * d["scales"].numel()


# -- error feedback -----------------------------------------------------------


class ErrorFeedback:
    """Per-key residual accumulator: the quantization error is carried into
    the next step's contribution instead of lost. ``encode(key, x)``
    returns ``quantize(x + residual[key])`` and keeps the new residual.
    Residuals are local to this process, never synchronised."""

    def __init__(self, codec: QuantCodec):
        self.codec = codec
        self._residual: Dict[Any, torch.Tensor] = {}

    def encode(self, key: Any, x: torch.Tensor) -> QuantizedTensor:
        x = x.to(torch.float32)
        res = self._residual.get(key)
        if res is not None and res.shape == x.shape:
            x = x + res
        qt = quantize(x, self.codec)
        self._residual[key] = x - dequantize(qt).to(torch.float32)
        return qt

    def residual_norm(self, key: Any) -> float:
        res = self._residual.get(key)
        return 0.0 if res is None else float(torch.linalg.vector_norm(res))

    def reset(self):
        self._residual.clear()


# -- the reduce point: dequantize, accumulate in fp32, quantize once ----------


def _fold(rows: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum in the given (rank) order, one addition at a time."""
    acc = rows[0]
    for row in rows[1:]:
        acc = acc + row
    return acc


def reduce_wire_payloads(payloads, codec_spec: str) -> Dict[str, Any]:
    """Dequantize every rank's payload (in rank order), sum in fp32, and
    quantize the sum once for the way back."""
    name, _, block = codec_spec.partition(":")
    codec = QuantCodec(name, int(block) if block else DEFAULT_BLOCK)
    total = _fold([dequantize(from_wire(p)).to(torch.float32)
                   for p in payloads])
    extras = [p["extra"] for p in payloads if p.get("extra") is not None]
    return to_wire(quantize(total, codec),
                   extra=_fold(extras) if extras else None)


# -- quantized reduce-scatter on a group --------------------------------------


def quantized_reduce_scatter_1d(group, codec: QuantCodec):
    """``fn(local_vec) -> owned_segment``: the reduce-scatter of a flat fp32
    vector over ``group`` (a ``TorchGroup``) with the codec's bytes on the
    wire. Each rank splits its vector into ``world_size`` segments, one a
    rank, encodes each by blocks (padding each segment's tail to a whole
    block), exchanges codes and scales with one all-to-all each, and sums
    the decoded segments it receives in fp32 in rank order: the JAX
    package's ``quantized_psum_scatter_1d``. The vector's length must be a
    multiple of the world size. ``fn(local_vec, async_op=True)`` encodes and
    starts the exchange, and returns a function that waits for it and
    gives the segment."""
    n = group.world_size
    block = codec.block

    def start(x: torch.Tensor):
        if x.dim() != 1 or x.numel() % n:
            raise ValueError(f"a flat vector whose length divides by {n} "
                             f"ranks, got {tuple(x.shape)}")
        seg_len = x.numel() // n
        seg = x.to(torch.float32).reshape(n, seg_len)
        if codec.name == "bf16":
            mine = group.alltoall(seg.to(torch.bfloat16), async_op=True)
            return lambda: _fold(list(mine().to(torch.float32)))
        nb = -(-seg_len // block)
        seg = torch.nn.functional.pad(seg, (0, nb * block - seg_len))
        q, scales = block_encode(seg.reshape(n, nb, block), codec.name)
        q = group.alltoall(q.view(torch.uint8), async_op=True)
        scales = group.alltoall(scales, async_op=True)

        def finish() -> torch.Tensor:
            codes = q().view(_CODE_DTYPES[codec.name])
            vals = codes.to(torch.float32) * scales()[..., None]
            return _fold(list(vals)).reshape(-1)[:seg_len]

        return finish

    def fn(x: torch.Tensor, async_op: bool = False):
        finish = start(x)
        return finish if async_op else finish()

    return fn


def reduce_scatter_wire_bytes(n_elements: int, world: int,
                              codec: Optional[QuantCodec]) -> int:
    """Bytes a rank sends in one reduce-scatter of ``n_elements`` values:
    the (N - 1) / N share that leaves it, fp32 when ``codec`` is None (the
    JAX package's ``xla_wire_bytes``)."""
    frac = (world - 1) / max(world, 1)
    per = 4.0 if codec is None else codec.bytes_per_element
    return int(n_elements * per * frac)
