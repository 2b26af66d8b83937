"""Nested schema model and its decomposition into columns.

Mirrors RNTuple's field/column split (paper §3): acyclic nested data
structures are decomposed recursively into *fields*; variable-length
collections become an *offset column* pointing into the columns of the
element field.  Leaves map to columns of primitive fixed-size types.

Example (paper Fig. 1 / Table 1)::

    schema = Schema([
        Leaf("fId", "int32"),
        Collection("fTracks", Record("_0", [
            Leaf("fEnergy", "float32"),
            Collection("fIds", Leaf("_0", "int32")),
        ])),
    ])

producing columns::

    0 fId                    leaf  int32
    1 fTracks                offset int64
    2 fTracks._0.fEnergy     leaf  float32
    3 fTracks._0.fIds        offset int64
    4 fTracks._0.fIds._0     leaf  int32
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field as dc_field, replace as dc_replace
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

# ---------------------------------------------------------------------------
# Primitive types

_DTYPES: Dict[str, np.dtype] = {
    "bool": np.dtype(np.bool_),
    "int8": np.dtype(np.int8),
    "uint8": np.dtype(np.uint8),
    "int16": np.dtype(np.int16),
    "uint16": np.dtype(np.uint16),
    "int32": np.dtype(np.int32),
    "uint32": np.dtype(np.uint32),
    "int64": np.dtype(np.int64),
    "uint64": np.dtype(np.uint64),
    "float16": np.dtype(np.float16),
    "float32": np.dtype(np.float32),
    "float64": np.dtype(np.float64),
}

OFFSET_DTYPE = np.dtype(np.int64)


def dtype_of(name: str) -> np.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported primitive type {name!r}") from None


# ---------------------------------------------------------------------------
# Field tree


class Field:
    """Base class of the field tree."""

    name: str

    def children(self) -> Sequence["Field"]:
        raise NotImplementedError

    def to_dict(self) -> Dict[str, Any]:
        raise NotImplementedError

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Field":
        kind = d["kind"]
        if kind == "leaf":
            return Leaf(d["name"], d["type"])
        if kind == "collection":
            return Collection(d["name"], Field.from_dict(d["item"]))
        if kind == "record":
            return Record(d["name"], [Field.from_dict(c) for c in d["fields"]])
        raise ValueError(f"unknown field kind {kind!r}")


@dataclass(frozen=True)
class Leaf(Field):
    """A primitive field, mapped to exactly one column."""

    name: str
    type: str

    def __post_init__(self) -> None:
        dtype_of(self.type)  # validate

    @property
    def dtype(self) -> np.dtype:
        return dtype_of(self.type)

    def children(self) -> Sequence[Field]:
        return ()

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": "leaf", "name": self.name, "type": self.type}


@dataclass(frozen=True)
class Collection(Field):
    """Variable-length collection: offset column + item field columns."""

    name: str
    item: Field

    def children(self) -> Sequence[Field]:
        return (self.item,)

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": "collection", "name": self.name, "item": self.item.to_dict()}


@dataclass(frozen=True)
class Record(Field):
    """A struct of sub-fields; produces no column of its own."""

    name: str
    fields: Tuple[Field, ...]

    def __init__(self, name: str, fields: Sequence[Field]):
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "fields", tuple(fields))

    def children(self) -> Sequence[Field]:
        return self.fields

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": "record",
            "name": self.name,
            "fields": [f.to_dict() for f in self.fields],
        }


# ---------------------------------------------------------------------------
# Column model

KIND_LEAF = 0
KIND_OFFSET = 1

# Default preconditioning encodings (see encoding.py).
ENC_NONE = "none"
ENC_SPLIT = "split"
ENC_DELTA_ZIGZAG_SPLIT = "dzs"


@dataclass(frozen=True)
class ColumnSpec:
    """A physical column of primitive fixed-size elements.

    ``codec``/``level`` are optional per-column entropy-coder overrides
    (ROOT's per-column codec choice): ``None``/``-1`` defer to the
    writer's ``WriteOptions`` (which may itself carry per-path overrides
    — resolution order is ``WriteOptions.column_codecs`` >
    ``ColumnSpec.codec`` > ``WriteOptions.codec``).  They are write-side
    hints only: the codec actually used is recorded per page in
    ``PageDesc.codec``, so readers never depend on these fields.
    """

    index: int              # column id, dense 0..n-1
    path: str               # dotted field path, e.g. "fTracks._0.fIds"
    kind: int               # KIND_LEAF or KIND_OFFSET
    type: str               # primitive type name
    encoding: str           # preconditioning encoding id
    codec: Optional[Any] = None   # codec name/id override (None = writer default)
    level: int = -1               # codec level override (-1 = codec default)

    @property
    def dtype(self) -> np.dtype:
        return dtype_of(self.type)

    @property
    def itemsize(self) -> int:
        return self.dtype.itemsize

    def to_dict(self) -> Dict[str, Any]:
        d = {
            "index": self.index,
            "path": self.path,
            "kind": self.kind,
            "type": self.type,
            "encoding": self.encoding,
        }
        if self.codec is not None:
            d["codec"] = self.codec
        if self.level >= 0:
            d["level"] = self.level
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ColumnSpec":
        return ColumnSpec(d["index"], d["path"], d["kind"], d["type"],
                          d["encoding"], d.get("codec"), d.get("level", -1))


def _default_encoding(kind: int, type_name: str) -> str:
    if kind == KIND_OFFSET:
        return ENC_DELTA_ZIGZAG_SPLIT
    itemsize = dtype_of(type_name).itemsize
    return ENC_SPLIT if itemsize > 1 else ENC_NONE


class Schema:
    """Top-level entry schema: an implicit record of named fields.

    Performs the recursive decomposition into columns once at construction.
    ``columns[i]`` is the i-th physical column; ``parent[i]`` is the column
    index of the enclosing offset column (or -1 at top level), which defines
    the nesting used by readers and by the repetition/packing logic.
    """

    def __init__(self, fields: Sequence[Field]):
        self.fields: Tuple[Field, ...] = tuple(fields)
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate top-level field names: {names}")
        self.columns: List[ColumnSpec] = []
        self.parent: List[int] = []
        # field path -> column index (offset column for collections,
        # data column for leaves)
        self.column_of_path: Dict[str, int] = {}
        for f in self.fields:
            self._decompose(f, prefix="", parent=-1)

    # -- decomposition ----------------------------------------------------

    def _add_column(self, path: str, kind: int, type_name: str, parent: int) -> int:
        idx = len(self.columns)
        enc = _default_encoding(kind, type_name)
        self.columns.append(ColumnSpec(idx, path, kind, type_name, enc))
        self.parent.append(parent)
        self.column_of_path[path] = idx
        return idx

    def _decompose(self, f: Field, prefix: str, parent: int) -> None:
        path = f"{prefix}{f.name}" if prefix == "" else f"{prefix}.{f.name}"
        if isinstance(f, Leaf):
            self._add_column(path, KIND_LEAF, f.type, parent)
        elif isinstance(f, Collection):
            off = self._add_column(path, KIND_OFFSET, "int64", parent)
            self._decompose(f.item, path, off)
        elif isinstance(f, Record):
            for c in f.fields:
                self._decompose(c, path, parent)
        else:  # pragma: no cover - defensive
            raise TypeError(f"unknown field type {type(f)!r}")

    # -- (de)serialization -------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(
            {"fields": [f.to_dict() for f in self.fields]},
            separators=(",", ":"),
        )

    @staticmethod
    def from_json(s: Union[str, bytes]) -> "Schema":
        d = json.loads(s)
        return Schema([Field.from_dict(f) for f in d["fields"]])

    # -- helpers -----------------------------------------------------------

    @property
    def n_columns(self) -> int:
        return len(self.columns)

    def top_level_columns(self) -> List[ColumnSpec]:
        return [c for c, p in zip(self.columns, self.parent) if p == -1]

    def children_of(self, column_index: int) -> List[ColumnSpec]:
        return [c for c, p in zip(self.columns, self.parent) if p == column_index]

    def project(self, keep_fields: Sequence[str]) -> "Schema":
        """Horizontal skim: a new Schema with only ``keep_fields``."""
        by_name = {f.name: f for f in self.fields}
        missing = [n for n in keep_fields if n not in by_name]
        if missing:
            raise KeyError(f"unknown fields: {missing}")
        return Schema([by_name[n] for n in keep_fields])

    def set_column_codec(self, path: str, codec, level: int = -1) -> "Schema":
        """Attach a per-column codec override (returns ``self`` for
        chaining).  Columns are write-side derived state — not part of
        the serialized field tree — so this does not affect equality or
        the on-disk header; the chosen codec lands per page in
        ``PageDesc.codec``."""
        idx = self.column_of_path[path]
        self.columns[idx] = dc_replace(self.columns[idx], codec=codec,
                                       level=level)
        return self

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Schema) and self.to_json() == other.to_json()

    def __repr__(self) -> str:
        cols = ", ".join(f"{c.index}:{c.path}" for c in self.columns)
        return f"Schema({cols})"


# ---------------------------------------------------------------------------
# Entry <-> column decomposition at fill time
#
# A "decomposed entry" is the per-column contribution of a single entry:
# for each leaf column a 1-D array of elements, for each offset column the
# list of collection sizes observed (one size per *parent element*).


def decompose_entry(schema: Schema, entry: Dict[str, Any]) -> List[np.ndarray]:
    """Decompose one nested dict entry into per-column element arrays.

    Offset-column contributions are *sizes* (not absolute offsets); the
    cluster builder integrates them into cluster-relative offsets, which is
    what makes clusters relocatable (paper §5).
    """
    out: List[List[Any]] = [[] for _ in schema.columns]

    def walk(field: Field, value: Any, prefix: str) -> None:
        path = f"{prefix}{field.name}" if prefix == "" else f"{prefix}.{field.name}"
        if isinstance(field, Leaf):
            out[schema.column_of_path[path]].append(value)
        elif isinstance(field, Collection):
            seq = value if value is not None else ()
            out[schema.column_of_path[path]].append(len(seq))
            for item in seq:
                walk(field.item, item, path)
        elif isinstance(field, Record):
            for sub in field.fields:
                walk(sub, value[sub.name], path)

    for f in schema.fields:
        walk(f, entry[f.name], "")

    arrays: List[np.ndarray] = []
    for col, vals in zip(schema.columns, out):
        dt = OFFSET_DTYPE if col.kind == KIND_OFFSET else col.dtype
        arrays.append(np.asarray(vals, dtype=dt))
    return arrays


def recompose_entries(
    schema: Schema, columns: List[np.ndarray], n_entries: int
) -> List[Dict[str, Any]]:
    """Inverse of repeated :func:`decompose_entry` — used by the reader.

    ``columns[i]`` holds the full element array of column *i* for the entry
    range, with offset columns already converted back to sizes is NOT
    assumed: offset columns here contain *absolute offsets within the
    range* (standard on-disk form), i.e. offsets[j] = end of collection j.
    """
    cursors = [0] * len(columns)

    def read_one(field: Field, prefix: str) -> Any:
        path = f"{prefix}{field.name}" if prefix == "" else f"{prefix}.{field.name}"
        if isinstance(field, Leaf):
            ci = schema.column_of_path[path]
            v = columns[ci][cursors[ci]]
            cursors[ci] += 1
            return v.item() if isinstance(v, np.generic) else v
        if isinstance(field, Collection):
            ci = schema.column_of_path[path]
            end = int(columns[ci][cursors[ci]])
            start = int(columns[ci][cursors[ci] - 1]) if cursors[ci] > 0 else 0
            cursors[ci] += 1
            return [read_one(field.item, path) for _ in range(end - start)]
        if isinstance(field, Record):
            return {sub.name: read_one(sub, path) for sub in field.fields}
        raise TypeError(type(field))

    return [
        {f.name: read_one(f, "") for f in schema.fields} for _ in range(n_entries)
    ]


# ---------------------------------------------------------------------------
# Columnar batch form (the fast path used by the ML pipeline and benchmarks)


@dataclass
class ColumnBatch:
    """N entries in decomposed columnar form.

    ``sizes[path]`` for each collection (per parent element), ``values[path]``
    flat element arrays for each leaf.  This is the zero-python-loop fill
    path; :meth:`from_entries` exists for convenience/testing.
    """

    schema: Schema
    n_entries: int
    data: Dict[int, np.ndarray] = dc_field(default_factory=dict)  # column idx -> arr

    @staticmethod
    def from_arrays(schema: Schema, n_entries: int, by_path: Dict[str, np.ndarray]) -> "ColumnBatch":
        data: Dict[int, np.ndarray] = {}
        for col in schema.columns:
            arr = by_path.get(col.path)
            if arr is None:
                raise KeyError(f"missing array for column {col.path!r}")
            dt = OFFSET_DTYPE if col.kind == KIND_OFFSET else col.dtype
            data[col.index] = np.ascontiguousarray(arr, dtype=dt)
        b = ColumnBatch(schema, n_entries, data)
        b.validate()
        return b

    @staticmethod
    def from_entries(schema: Schema, entries: Sequence[Dict[str, Any]]) -> "ColumnBatch":
        per_col: List[List[np.ndarray]] = [[] for _ in schema.columns]
        for e in entries:
            for i, arr in enumerate(decompose_entry(schema, e)):
                per_col[i].append(arr)
        data = {}
        for col in schema.columns:
            dt = OFFSET_DTYPE if col.kind == KIND_OFFSET else col.dtype
            parts = per_col[col.index]
            data[col.index] = (
                np.concatenate(parts) if parts else np.empty(0, dtype=dt)
            ).astype(dt, copy=False)
        b = ColumnBatch(schema, len(entries), data)
        b.validate()
        return b

    def validate(self) -> None:
        """Check size consistency between offset columns and children."""
        for col in self.schema.columns:
            parent = self.schema.parent[col.index]
            expect = (
                self.n_entries
                if parent == -1
                else int(self.data[parent].sum())
            )
            got = len(self.data[col.index])
            if got != expect:
                raise ValueError(
                    f"column {col.path!r}: {got} elements, expected {expect}"
                )

    def sizes_to_entry_arrays(self) -> Dict[int, np.ndarray]:
        return self.data
