"""Length-prefixed JSON framing shared by the zygote and its raylet-side
control channel (kept dependency-free: the zygote imports it before the
heavy preimports, and running ``python -m ...provisioner.zygote`` must not
re-import the module executing as __main__)."""

from __future__ import annotations

import json
import os
import struct

_LEN = struct.Struct(">I")


def encode_frame(msg: dict) -> bytes:
    blob = json.dumps(msg).encode()
    return _LEN.pack(len(blob)) + blob


def send_frame(fd: int, msg: dict) -> None:
    data = encode_frame(msg)
    while data:
        n = os.write(fd, data)
        data = data[n:]


class FrameReader:
    """Incremental length-prefixed JSON frame decoder over a raw fd buffer."""

    def __init__(self):
        self.buf = b""

    def feed(self, data: bytes):
        self.buf += data
        while len(self.buf) >= _LEN.size:
            (n,) = _LEN.unpack(self.buf[:_LEN.size])
            if len(self.buf) < _LEN.size + n:
                return
            blob = self.buf[_LEN.size:_LEN.size + n]
            self.buf = self.buf[_LEN.size + n:]
            yield json.loads(blob)
