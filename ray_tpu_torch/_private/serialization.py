"""Object serialization: pickle protocol 5 with out-of-band buffers, the
port of ``ray_tpu/_private/serialization.py`` (``dumps_oob``, ``loads_oob``,
``loads_trusted``).

The JAX module pickles with ``cloudpickle``; the port uses the standard
library's ``pickle`` at the same protocol, which writes the same blob layout
and reads the JAX module's blobs of plain values. What it cannot pickle is a
value defined in ``__main__`` or a lambda, which no checkpoint leaf is.
Tensors are turned into numpy arrays first, as the JAX module turns jax
arrays.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, List, Tuple

# Payloads >= this many bytes are pulled out-of-band; below it, inline pickling
# is cheaper than a separate buffer round trip.
_OOB_THRESHOLD = 1024


def _to_picklable(value: Any) -> Any:
    """A torch tensor as a host numpy array; anything else as it is."""
    import torch

    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return value


def serialize(value: Any) -> Tuple[bytes, List[memoryview]]:
    """Returns (inband_bytes, out_of_band_buffers)."""
    buffers: List[memoryview] = []

    def buffer_cb(pickle_buffer):
        mv = pickle_buffer.raw()
        if mv.nbytes >= _OOB_THRESHOLD:
            buffers.append(mv)
            return False  # out of band
        return True  # keep in band

    inband = pickle.dumps(_to_picklable(value), protocol=5,
                          buffer_callback=buffer_cb)
    return inband, buffers


def deserialize(inband: bytes, buffers: List[Any]) -> Any:
    return pickle.loads(inband, buffers=[pickle.PickleBuffer(b) for b in buffers])


def loads_trusted(blob: bytes) -> Any:
    """Unpickle a blob whose PRODUCER is trusted (this program, or the JAX
    package's checkpoint plane). Unpickling runs code named in the blob, so
    this is the one place the port unpickles."""
    return pickle.loads(blob)


def dumps_oob(value: Any) -> bytes:
    """Single-blob serialization: [u32 nbuf][u64 len, bytes]* [inband]."""
    inband, buffers = serialize(value)
    out = io.BytesIO()
    out.write(len(buffers).to_bytes(4, "big"))
    for b in buffers:
        out.write(b.nbytes.to_bytes(8, "big"))
        out.write(b)
    out.write(inband)
    return out.getvalue()


def loads_oob(blob: bytes) -> Any:
    view = memoryview(blob)
    nbuf = int.from_bytes(view[:4], "big")
    off = 4
    buffers = []
    for _ in range(nbuf):
        n = int.from_bytes(view[off : off + 8], "big")
        off += 8
        buffers.append(view[off : off + n])
        off += n
    return deserialize(bytes(view[off:]), buffers)
