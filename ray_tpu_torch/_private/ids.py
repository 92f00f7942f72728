"""Binary identifiers for jobs, tasks, actors, objects, nodes, placement groups.

Equivalent of the reference's ``src/ray/common/id.h`` /
``src/ray/design_docs/id_specification.md``: fixed-width random ids with
structured derivation (an ObjectID embeds the id of the task that produces it
plus a return index, so ownership and lineage can be recovered from the id
itself).
"""

from __future__ import annotations

import os
import struct


class BaseID:
    SIZE = 16
    __slots__ = ("_bytes",)

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(id_bytes)}"
            )
        self._bytes = id_bytes

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        return hash((type(self).__name__, self._bytes))

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()[:12]})"


class JobID(BaseID):
    SIZE = 4

    @classmethod
    def from_int(cls, i: int):
        return cls(struct.pack(">I", i))


class NodeID(BaseID):
    pass


class WorkerID(BaseID):
    pass


class ActorID(BaseID):
    SIZE = 12

    @classmethod
    def of(cls, job_id: JobID):
        return cls(os.urandom(cls.SIZE - JobID.SIZE) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[-JobID.SIZE:])


class TaskID(BaseID):
    SIZE = 14

    @classmethod
    def of(cls, job_id: JobID):
        return cls(os.urandom(cls.SIZE - JobID.SIZE) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[-JobID.SIZE:])


class ObjectID(BaseID):
    # task id (14) + big-endian return index (2)
    SIZE = 16

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int):
        return cls(task_id.binary() + struct.pack(">H", index))

    @classmethod
    def from_put(cls, task_id: TaskID, put_index: int):
        # puts use the high bit of the index space to avoid colliding with returns
        return cls(task_id.binary() + struct.pack(">H", 0x8000 | put_index))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[: TaskID.SIZE])

    def return_index(self) -> int:
        return struct.unpack(">H", self._bytes[TaskID.SIZE:])[0]


class PlacementGroupID(BaseID):
    SIZE = 12
