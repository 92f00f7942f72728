"""Blocks: the unit of data movement, the port of ``ray_tpu/data/block.py``
(reference: python/ray/data/block.py).

The JAX package's tabular block is a pyarrow ``Table``; the card's machine
has no pyarrow, so the port's is :class:`Table`, a columnar block of its own:
one numpy array per column (numbers and bools typed, with a validity mask
where a column holds nulls; strings, bytes, lists and structs as object
arrays of Python values), in the column types arrow would infer. A block
is a :class:`Table` (rows of dicts) or a plain Python list (anything
else), and it behaves as the JAX block does where a user can see it:

- :meth:`BlockAccessor.build_from_rows` takes the columns of the first
  row, fills a missing value with ``None`` and drops keys the first row
  lacks, and falls back to a list block where the values of a column do
  not share a type (an int beside a str, a bool beside an int), as
  ``pyarrow.Table.from_pylist`` does;
- :meth:`BlockAccessor.to_rows` gives Python scalars (``to_pylist``);
- :meth:`BlockAccessor.to_batch` gives arrow's ``to_numpy`` dtypes: an
  integer column with nulls becomes float64 with NaN, a bool column with
  nulls, strings, bytes and lists become object arrays (a list cell as a
  numpy array).

Numeric columns cross the object store as out-of-band numpy buffers.
Batches surface as dicts of numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

_NUMERIC = ("bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
            "uint32", "uint64", "float16", "float32", "float64")


class _Mixed(TypeError):
    """Values of one column that arrow could not put in one type."""


# ---------------------------------------------------------------------------
# type inference (pyarrow's, from Python and numpy values)
# ---------------------------------------------------------------------------


def _kind(v) -> Tuple[str, Any]:
    """(kind, numpy dtype name or None) of one non-null value."""
    if isinstance(v, (bool, np.bool_)):
        return "bool", None
    if isinstance(v, int):
        return "int", None
    if isinstance(v, np.integer):
        return "int", v.dtype.name
    if isinstance(v, float):
        return "float", None
    if isinstance(v, np.floating):
        return "float", v.dtype.name
    if isinstance(v, str):
        return "string", None
    if isinstance(v, (bytes, bytearray)):
        return "binary", None
    if isinstance(v, (list, tuple)):
        return "list", None
    if isinstance(v, np.ndarray):
        if v.ndim != 1:
            raise _Mixed("only 1-dimensional arrays convert to a list")
        return "list", None
    if isinstance(v, dict):
        return "struct", None
    raise _Mixed(f"no column type for {type(v).__name__}")


def _infer(values) -> str:
    """The column type arrow infers for ``values`` (None = null), or
    :class:`_Mixed` where it refuses."""
    values = list(values)
    kinds = set()
    dtypes = set()
    any_python_num = False
    for v in values:
        if v is None:
            continue
        k, dt = _kind(v)
        kinds.add(k)
        if dt is None and k in ("int", "float"):
            any_python_num = True
        elif dt is not None:
            dtypes.add(dt)
    if not kinds:
        return "null"
    if len(kinds) == 1:
        (k,) = kinds
        if k == "bool":
            return "bool"
        if k in ("string", "binary"):
            return k
        if k == "list":
            return "list<" + _infer(
                x for v in values if v is not None for x in v) + ">"
        if k == "struct":
            return "struct"
        if k == "int":
            if not any_python_num and len(dtypes) == 1:
                return dtypes.pop()
            return "int64"
        # floats
        if not any_python_num and len(dtypes) == 1:
            return dtypes.pop()
        if len(dtypes) > 1:
            raise _Mixed(f"cannot mix numpy dtypes {sorted(dtypes)}")
        return "float64"
    if kinds == {"string", "binary"}:
        return "binary"
    if kinds == {"int", "float"}:
        return "float64"
    raise _Mixed(f"values of kinds {sorted(kinds)} in one column")


def _cast(v, typ: str):
    """One non-null value as ``to_pylist`` gives it in a column of
    ``typ``."""
    if typ.startswith("list<"):
        child = typ[5:-1]
        return [None if x is None else _cast(x, child) for x in v]
    if typ == "struct":
        return _struct_rows([v])[0]
    if typ == "bool":
        return bool(v)
    if typ.startswith(("int", "uint")):
        return int(v)
    if typ.startswith("float"):
        return float(np.dtype(typ).type(v))
    if typ == "string":
        return str(v)
    if typ == "binary":
        return v.encode() if isinstance(v, str) else bytes(v)
    return v


def _struct_rows(values) -> List[Optional[dict]]:
    """Struct cells with the union of the fields (in first-seen order), a
    missing field as None, each field cast to its inferred type."""
    fields: Dict[str, None] = {}
    for v in values:
        if v is not None:
            for k in v:
                fields.setdefault(k, None)
    types = {k: _infer(v.get(k) for v in values if v is not None)
             for k in fields}
    return [None if v is None else {
        k: None if v.get(k) is None else _cast(v.get(k), types[k])
        for k in fields} for v in values]


def _int_overflow(typ: str, values) -> None:
    if typ == "int64":
        for v in values:
            if v is not None and not (-(1 << 63) <= v < (1 << 63)):
                raise _Mixed("Python int too large to convert to C long")


class Column:
    """One column: its arrow-style type name, its values, and (numbers and
    bools only) which rows are valid, where any is null."""

    __slots__ = ("type", "data", "valid")

    def __init__(self, typ: str, data: np.ndarray,
                 valid: Optional[np.ndarray] = None):
        self.type = typ
        self.data = data
        self.valid = valid

    @staticmethod
    def from_values(values: List[Any], typ: Optional[str] = None) -> "Column":
        """The column of ``values`` (None = null), in ``typ`` or the type
        arrow infers for them."""
        typ = typ or _infer(values)
        if typ in _NUMERIC:
            _int_overflow(typ, values)
            valid = np.fromiter((v is not None for v in values), bool,
                                len(values))
            fill = False if typ == "bool" else 0
            data = np.array([fill if v is None else v for v in values],
                            dtype=typ) if values else np.zeros(0, typ)
            return Column(typ, data, None if valid.all() else valid)
        if typ == "struct":
            cells = _struct_rows(values)
        else:
            cells = [None if v is None else _cast(v, typ) for v in values]
        data = np.empty(len(cells), dtype=object)
        data[:] = cells
        return Column(typ, data)

    @staticmethod
    def from_array(arr: np.ndarray) -> "Column":
        """A 1-d numpy array as ``pyarrow.array`` takes it: numbers keep
        their dtype (NaN stays a value), str and bytes arrays become string
        and binary, object arrays are inferred value by value."""
        if arr.dtype.kind in "biuf" and arr.dtype.name in _NUMERIC:
            return Column(arr.dtype.name, arr)
        if arr.dtype.kind == "U":
            return Column.from_values([str(v) for v in arr])
        if arr.dtype.kind == "S":
            return Column.from_values([bytes(v) for v in arr])
        if arr.dtype.kind == "O":
            return Column.from_values(list(arr))
        raise _Mixed(f"no column type for numpy dtype {arr.dtype}")

    def __len__(self) -> int:
        return len(self.data)

    def to_pylist(self) -> List[Any]:
        if self.type not in _NUMERIC:
            return list(self.data)
        out = self.data.tolist()
        if self.valid is not None:
            for i in np.flatnonzero(~self.valid):
                out[i] = None
        return out

    def to_numpy(self) -> np.ndarray:
        """arrow's ``to_numpy(zero_copy_only=False)`` of this column."""
        if self.type in _NUMERIC:
            if self.valid is None:
                return self.data
            if self.type == "bool":
                out = np.empty(len(self.data), dtype=object)
                out[:] = self.to_pylist()
                return out
            dt = self.data.dtype if self.type.startswith("float") \
                else np.float64
            out = self.data.astype(dt)
            out[~self.valid] = np.nan
            return out
        if self.type.startswith("list<"):
            child = self.type[5:-1]
            out = np.empty(len(self.data), dtype=object)
            out[:] = [None if v is None else _list_numpy(v, child)
                      for v in self.data]
            return out
        return self.data

    def slice(self, start: int, end: int) -> "Column":
        return Column(self.type, self.data[start:end],
                      None if self.valid is None else self.valid[start:end])

    def nbytes(self) -> int:
        if self.type in _NUMERIC:
            return self.data.nbytes + (0 if self.valid is None
                                       else (len(self.data) + 7) // 8)
        if self.type in ("string", "binary"):
            return 4 * (len(self.data) + 1) + sum(
                len(v) for v in self.data if v is not None)
        return 8 * len(self.data)


def _list_numpy(cell: list, child: str) -> np.ndarray:
    """A list cell as arrow's ``to_numpy`` gives it: a numpy array of the
    child type (with NaN or None for nulls, as a column would have)."""
    return Column.from_values(cell, child).to_numpy()


class Schema:
    """A table's column names and type names (what ``Dataset.schema``
    returns for a tabular block, as arrow's schema is in the JAX
    package)."""

    __slots__ = ("names", "types")

    def __init__(self, names: List[str], types: List[str]):
        self.names = names
        self.types = types

    def __eq__(self, other):
        return isinstance(other, Schema) and (self.names, self.types) == (
            other.names, other.types)

    def __repr__(self):
        return "\n".join(f"{n}: {t}" for n, t in zip(self.names, self.types))


class Table:
    """The port's tabular block: named columns of one length."""

    __slots__ = ("columns",)

    def __init__(self, columns: Dict[str, Column]):
        self.columns = columns

    @property
    def num_rows(self) -> int:
        for col in self.columns.values():
            return len(col)
        return 0

    @property
    def column_names(self) -> List[str]:
        return list(self.columns)

    @property
    def schema(self) -> Schema:
        return Schema(list(self.columns),
                      [c.type for c in self.columns.values()])

    def to_pylist(self) -> List[dict]:
        names = list(self.columns)
        cols = [c.to_pylist() for c in self.columns.values()]
        return [dict(zip(names, vals)) for vals in zip(*cols)]

    def slice(self, start: int, end: int) -> "Table":
        return Table({k: c.slice(start, end) for k, c in self.columns.items()})

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes() for c in self.columns.values())

    def __repr__(self):
        return f"Table({self.num_rows} rows; {self.schema!r})"


Block = Union[Table, List[Any]]


def table_from_rows(rows: List[dict]) -> Table:
    """``pyarrow.Table.from_pylist``: the first row's keys, values of one
    type a column; raises :class:`TypeError` where a column's values mix."""
    names = list(rows[0])
    return Table({k: Column.from_values([r.get(k) for r in rows])
                  for k in names})


class BlockAccessor:
    def __init__(self, block: Block):
        self.block = block

    @staticmethod
    def build_from_rows(rows: List[Any]) -> Block:
        """Rows of dicts -> a Table; anything else -> a list block."""
        if rows and all(isinstance(r, dict) for r in rows):
            try:
                return table_from_rows(rows)
            except _Mixed:
                return list(rows)
        return list(rows)

    @staticmethod
    def build_from_batch(batch: Dict[str, np.ndarray]) -> Block:
        cols = {k: np.asarray(v) for k, v in batch.items()}
        try:
            lengths = {len(v) for v in cols.values()}
            if len(lengths) > 1:
                raise _Mixed("columns of different lengths")
            return Table({k: Column.from_values(v.tolist()) if v.ndim > 1
                          else Column.from_array(v)
                          for k, v in cols.items()})
        except (_Mixed, TypeError):
            n = len(next(iter(cols.values())))
            return [{k: v[i] for k, v in cols.items()} for i in range(n)]

    def num_rows(self) -> int:
        return self.block.num_rows if self._is_table() else len(self.block)

    def _is_table(self) -> bool:
        return isinstance(self.block, Table)

    def to_rows(self) -> List[Any]:
        if self._is_table():
            return self.block.to_pylist()
        return list(self.block)

    def to_batch(self) -> Dict[str, np.ndarray]:
        if self._is_table():
            return {name: col.to_numpy()
                    for name, col in self.block.columns.items()}
        if self.block and all(isinstance(r, dict) for r in self.block):
            keys = self.block[0].keys()
            return {k: np.asarray([r[k] for r in self.block]) for k in keys}
        return {"item": np.asarray(self.block, dtype=object)}

    def slice(self, start: int, end: int) -> Block:
        if self._is_table():
            return self.block.slice(start, end)
        return self.block[start:end]

    def to_pandas(self):
        pd = _pandas("to_pandas")
        if self._is_table():
            return pd.DataFrame(self.to_batch(), columns=self.block.column_names)
        return pd.DataFrame(self.to_rows())

    def size_bytes(self) -> int:
        if self._is_table():
            return self.block.nbytes
        return sum(64 for _ in self.block)  # rough


def _pandas(what: str):
    """pandas, imported where a call needs it; an ImportError naming it
    where it is missing (the card's machine has no pandas)."""
    try:
        import pandas
    except ImportError as e:
        raise ImportError(f"{what} needs pandas, which is not installed "
                          f"({e})") from e
    return pandas


def _pyarrow(what: str):
    """pyarrow with its parquet module, imported where a call needs it; an
    ImportError naming it where it is missing (the card's machine has no
    pyarrow)."""
    try:
        import pyarrow
        import pyarrow.parquet  # noqa: F401
    except ImportError as e:
        raise ImportError(f"{what} needs pyarrow, which is not installed "
                          f"({e})") from e
    return pyarrow


def widened_batch(blocks: List[Block]) -> Optional[Dict[str, np.ndarray]]:
    """The batch that rebuilding these blocks' rows would give, taken from
    their columns directly, where every block is a Table with the same
    columns of numbers or bools and no nulls; else None. Python scalars
    from such a row rebuild as float64, int64 or bool, so the columns widen
    to those."""
    if not blocks or not all(isinstance(b, Table) for b in blocks):
        return None
    names = blocks[0].column_names
    if not names:
        return None
    for b in blocks:
        if b.column_names != names or any(
                c.type not in _NUMERIC or c.valid is not None
                for c in b.columns.values()):
            return None
    out = {}
    for k in names:
        arr = np.concatenate([b.columns[k].data for b in blocks])
        kind = arr.dtype.kind
        if kind == "f":
            arr = arr.astype(np.float64, copy=False)
        elif kind in "iu":
            if kind == "u" and arr.dtype.itemsize == 8 and len(arr) and \
                    arr.max() >= (1 << 63):
                return None
            arr = arr.astype(np.int64, copy=False)
        out[k] = arr
    return out
