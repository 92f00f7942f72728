"""Object serialization: pickle protocol 5 with out-of-band buffers, the
port of ``ray_tpu/_private/serialization.py``.

Two paths share the blob layout:

- The runtime's (:func:`serialize`, :func:`dumps`): a pickler that ships
  functions and classes by value where they cannot be imported by name
  (defined in ``__main__``, inside another function, lambdas), as the JAX
  module's ``cloudpickle`` does, and keeps tensors as tensors: a tensor
  crosses as its dtype, shape and dimension order plus one out-of-band host
  buffer, and comes back as a CPU tensor of the same dtype (bf16 included;
  a CUDA tensor is copied to the host first).
- The checkpoint plane's (:func:`dumps_oob`, :func:`loads_oob`): the
  standard library's pickler, with a tensor value turned into a numpy array
  first, so its blobs stay readable by the JAX package's plane.

Neither path imports torch: a tensor can only exist where torch is loaded
already, so a CPU-only worker that never touches one never loads it.
"""

from __future__ import annotations

import builtins
import importlib
import io
import marshal
import pickle
import sys
import types
from typing import Any, List, Tuple

# Payloads >= this many bytes are pulled out-of-band; below it, inline pickling
# is cheaper than a separate buffer round trip.
_OOB_THRESHOLD = 1024


def _torch():
    """The torch module if this process has loaded it, else None."""
    return sys.modules.get("torch")


# ---------------------------------------------------------------------------
# by-value functions and classes
# ---------------------------------------------------------------------------


def _lookup(module_name: str, qualname: str):
    obj = sys.modules.get(module_name)
    if obj is None:
        return None
    for part in qualname.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


def _by_reference(obj) -> bool:
    """True when ``obj`` (a function or class) is reachable by its module and
    qualified name in this process, so that pickle's own by-name reference
    reaches it in another process too."""
    module = getattr(obj, "__module__", None)
    qualname = getattr(obj, "__qualname__", "")
    if not module or module == "__main__" or "<locals>" in qualname \
            or "<lambda>" in qualname:
        return False
    return _lookup(module, qualname) is obj


def _code_names(code: types.CodeType, out: set) -> set:
    out.update(code.co_names)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            _code_names(const, out)
    return out


class _EmptyCell:
    """Stands for a closure cell not yet bound where the function was
    pickled."""


def _make_function(code: bytes, name: str, module: str, ncells: int):
    """The skeleton of a by-value function: its code and fresh globals and
    cells; :func:`_function_setstate` fills them once every object they name
    exists (so recursive and mutually recursive functions resolve)."""
    g = {"__builtins__": builtins, "__name__": module}
    closure = tuple(types.CellType() for _ in range(ncells)) or None
    return types.FunctionType(marshal.loads(code), g, name, None, closure)


def _function_setstate(fn, state):
    fn.__globals__.update(state["globals"])
    fn.__defaults__ = state["defaults"]
    fn.__kwdefaults__ = state["kwdefaults"]
    fn.__dict__.update(state["dict"])
    fn.__qualname__ = state["qualname"]
    fn.__module__ = state["module"]
    fn.__doc__ = state["doc"]
    fn.__annotations__ = state["annotations"]
    for cell, value in zip(fn.__closure__ or (), state["cells"]):
        if value is not _EmptyCell:
            cell.cell_contents = value
    return fn


def _function_reduce(fn):
    code = fn.__code__
    g = fn.__globals__
    used = {n: g[n] for n in sorted(_code_names(code, set())) if n in g}
    cells = []
    for cell in fn.__closure__ or ():
        try:
            cells.append(cell.cell_contents)
        except ValueError:  # a cell not yet bound
            cells.append(_EmptyCell)
    state = {"globals": used, "defaults": fn.__defaults__,
             "kwdefaults": fn.__kwdefaults__, "dict": dict(fn.__dict__),
             "qualname": fn.__qualname__, "module": fn.__module__,
             "doc": fn.__doc__, "annotations": dict(fn.__annotations__),
             "cells": cells}
    return (_make_function,
            (marshal.dumps(code), fn.__name__, fn.__module__ or "__main__",
             len(fn.__closure__ or ())),
            state, None, None, _function_setstate)


# class attributes that the class statement makes by itself
_CLASS_SKIP = ("__dict__", "__weakref__", "_abc_impl", "__module__",
               "__qualname__")


def _make_class(metaclass, name: str, bases: tuple, namespace: dict):
    return types.new_class(name, bases, {"metaclass": metaclass},
                           lambda ns: ns.update(namespace))


def _class_setstate(cls, state):
    for key, value in state.items():
        setattr(cls, key, value)
    return cls


def _class_reduce(cls):
    attrs = dict(cls.__dict__)
    slots = attrs.get("__slots__", ())
    for name in (slots,) if isinstance(slots, str) else slots:
        attrs.pop(name, None)  # the member descriptors the slots made
    for name in _CLASS_SKIP:
        attrs.pop(name, None)
    namespace = {"__module__": cls.__module__, "__qualname__": cls.__qualname__}
    if "__slots__" in attrs:
        namespace["__slots__"] = attrs.pop("__slots__")
    return (_make_class, (type(cls), cls.__name__, cls.__bases__, namespace),
            attrs, None, None, _class_setstate)


def _import_module(name: str):
    return importlib.import_module(name)


# ---------------------------------------------------------------------------
# tensors
# ---------------------------------------------------------------------------


def _dense_order(shape, strides):
    """The order of dimensions, outermost first, in which a tensor's memory
    is laid out without gaps or overlaps; None when it has none."""
    order = sorted(range(len(shape)), key=lambda d: (-strides[d], -d))
    expect = 1
    for d in reversed(order):
        if shape[d] != 1 and strides[d] != expect:
            return None
        expect *= shape[d]
    return order


def _rebuild_tensor(dtype: str, shape: tuple, order: tuple, buf,
                    requires_grad: bool, parameter: bool):
    import torch

    mv = memoryview(buf)
    if mv.readonly:  # torch cannot mark a tensor read-only: copy
        mv = memoryview(bytearray(mv))
    dt = getattr(torch, dtype)
    permuted = tuple(shape[d] for d in order)
    if mv.nbytes:
        flat = torch.frombuffer(mv, dtype=torch.uint8).view(dt)
    else:
        flat = torch.empty(0, dtype=dt)
    inverse = [0] * len(order)
    for i, d in enumerate(order):
        inverse[d] = i
    t = flat.reshape(permuted).permute(inverse)
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad) if requires_grad else t


def _tensor_reduce(torch, t):
    parameter = type(t) is torch.nn.Parameter
    if not parameter and type(t) is not torch.Tensor:
        return NotImplemented  # a subclass keeps its own reduction
    if t.layout != torch.strided or t.is_quantized:
        return NotImplemented
    requires_grad = t.requires_grad
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()  # from the card: one device-to-host copy
    t = t.resolve_conj().resolve_neg()
    order = _dense_order(t.shape, t.stride())
    if order is None:
        t = t.contiguous()
        order = list(range(t.dim()))
    raw = t.permute(order).reshape(-1).view(torch.uint8).numpy()
    return (_rebuild_tensor,
            (str(t.dtype).rsplit(".", 1)[1], tuple(t.shape), tuple(order),
             pickle.PickleBuffer(raw), requires_grad, parameter))


class _Pickler(pickle.Pickler):
    """Pickle's own pickler, plus by-value functions and classes, modules by
    name, and tensors as tensors."""

    def reducer_override(self, obj):
        t = type(obj)
        if t is types.FunctionType:
            return NotImplemented if _by_reference(obj) else _function_reduce(obj)
        if isinstance(obj, type):
            return NotImplemented if _by_reference(obj) else _class_reduce(obj)
        if t is staticmethod or t is classmethod:
            return t, (obj.__func__,)
        if t is property:
            return property, (obj.fget, obj.fset, obj.fdel, obj.__doc__)
        if t is types.ModuleType:
            if obj.__name__ == "__main__":
                raise pickle.PicklingError("cannot pickle the __main__ module")
            return _import_module, (obj.__name__,)
        torch = _torch()
        if torch is not None and isinstance(obj, torch.Tensor):
            return _tensor_reduce(torch, obj)
        return NotImplemented


def serialize(value: Any) -> Tuple[bytes, List[memoryview]]:
    """Returns (inband_bytes, out_of_band_buffers)."""
    buffers: List[memoryview] = []

    def buffer_cb(pickle_buffer):
        mv = pickle_buffer.raw()
        if mv.nbytes >= _OOB_THRESHOLD:
            buffers.append(mv)
            return False  # out of band
        return True  # keep in band

    out = io.BytesIO()
    _Pickler(out, protocol=5, buffer_callback=buffer_cb).dump(value)
    return out.getvalue(), buffers


def dumps(value: Any) -> bytes:
    """One in-band blob of ``value`` (functions and classes by value where
    needed): what the runtime ships a task's function or an actor's class
    as, read back with :func:`loads_trusted`."""
    out = io.BytesIO()
    _Pickler(out, protocol=5).dump(value)
    return out.getvalue()


def deserialize(inband: bytes, buffers: List[Any]) -> Any:
    return pickle.loads(inband, buffers=[pickle.PickleBuffer(b) for b in buffers])


def loads_trusted(blob: bytes) -> Any:
    """Unpickle a blob whose PRODUCER is trusted (this program, or the JAX
    package's checkpoint plane). Unpickling runs code named in the blob, so
    this is the one place the port unpickles a single blob; anything that
    must be safe against arbitrary senders goes through ``wire.py``, which
    never unpickles."""
    return pickle.loads(blob)


# ---------------------------------------------------------------------------
# the checkpoint plane's blobs
# ---------------------------------------------------------------------------


def _to_picklable(value: Any) -> Any:
    """A torch tensor as a host numpy array; anything else as it is."""
    torch = _torch()
    if torch is not None and isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return value


def dumps_oob(value: Any) -> bytes:
    """Single-blob serialization: [u32 nbuf][u64 len, bytes]* [inband]."""
    buffers: List[memoryview] = []

    def buffer_cb(pickle_buffer):
        mv = pickle_buffer.raw()
        if mv.nbytes >= _OOB_THRESHOLD:
            buffers.append(mv)
            return False
        return True

    inband = pickle.dumps(_to_picklable(value), protocol=5,
                          buffer_callback=buffer_cb)
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
