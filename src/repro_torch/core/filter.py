"""Typed filter expressions + zone-map pruning logic (DESIGN.md §11).

A small predicate language over *leaf fields* — comparisons, inclusive
ranges, null checks, and ``&``/``|``/``~`` combinators (hepconduit's
filtering shape)::

    from repro_torch.core.filter import F

    expr = (F("event_id").between(1000, 2000)
            & ((F("met") > 40.0) | ~F("jets_pt._0").is_null()))

Entry semantics
    A predicate evaluates to one boolean per *entry*.  A comparison on a
    top-level leaf (one element per entry) is elementwise; a comparison
    on a **nested** leaf (inside one or more collections) is
    *existential*: the entry matches iff **any** of its elements
    matches (an empty collection matches nothing).  ``~`` is plain
    logical negation of the entry value, so ``~(F("jets_pt._0") > x)``
    means "no jet above x" (vacuously true for zero jets).

Null model
    The container has no explicit nulls; for float columns ``NaN`` plays
    that role.  ``is_null`` tests NaN-ness (always false on integer
    columns); comparisons and ranges never match NaN (IEEE semantics).

Exactness rules (float bounds)
    Zone bounds are min/max over the *non-NaN* elements of a page
    (±inf participate; an all-NaN page has undefined bounds and a full
    null count).  To keep the zone decision and the exact mask
    consistent, both sides compare in ONE numeric domain: float64
    whenever the column or the constant is floating (float32 ⊂ float64,
    so this is exact), arbitrary-precision ints otherwise — constants
    that do not fit the column's integer range are rejected at
    :meth:`Expr.validate` time rather than silently rounded.

Three-valued zone evaluation (:meth:`Expr.zone_eval`) returns
``T_TRUE`` (every entry in the zone's range matches), ``T_FALSE`` (no
entry can match — the zone is prunable), or ``T_MAYBE``.  Nested-leaf
atoms never return ``T_TRUE`` (emptiness is unknowable from bounds),
which keeps Kleene negation sound.  The reader compiles these verdicts
into per-cluster/per-page prune plans (``reader.PrunePlan``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .schema import KIND_LEAF, Schema

__all__ = [
    "F",
    "Field",
    "Expr",
    "Zone",
    "T_TRUE",
    "T_FALSE",
    "T_MAYBE",
    "required_columns",
]

# three-valued logic verdicts
T_FALSE = 0
T_TRUE = 1
T_MAYBE = 2


def _not3(t: int) -> int:
    if t == T_MAYBE:
        return T_MAYBE
    return T_FALSE if t == T_TRUE else T_TRUE


# ---------------------------------------------------------------------------
# Zones: the reader-side summary a predicate is tested against


class Zone:
    """Value summary of one page (or a fold of pages) of a leaf column.

    ``lo``/``hi`` are min/max over non-NaN elements (``None`` when the
    zone holds no non-NaN element); ``nulls`` counts NaN elements;
    ``count`` is the total element count; ``nested`` marks leaves inside
    a collection (existential entry semantics).
    """

    __slots__ = ("lo", "hi", "nulls", "count", "nested")

    def __init__(self, lo, hi, nulls: int, count: int, nested: bool):
        # an all-NaN (or empty) zone has no usable bounds
        if lo is not None and isinstance(lo, float) and math.isnan(lo):
            lo = hi = None
        self.lo = lo
        self.hi = hi
        self.nulls = nulls
        self.count = count
        self.nested = nested

    @staticmethod
    def empty(nested: bool = True) -> "Zone":
        """A zone covering zero elements (entries whose collections are
        all empty for this column)."""
        return Zone(None, None, 0, 0, nested)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Zone(lo={self.lo}, hi={self.hi}, nulls={self.nulls}, "
                f"count={self.count}, nested={self.nested})")


# ---------------------------------------------------------------------------
# Evaluation context: exact per-entry masks over decoded column arrays


class EvalContext:
    """Decoded columns of one entry range, ready for exact evaluation.

    ``cols[i]`` holds column *i*'s elements for the range; offset
    columns hold **range-local** end offsets (the on-disk cluster form
    rebased to the range).  Entry attribution for nested leaves is
    derived on demand and cached.
    """

    def __init__(self, schema: Schema, cols: Dict[int, np.ndarray],
                 n_entries: int):
        self.schema = schema
        self.cols = cols
        self.n_entries = n_entries
        self._entry_ids: Dict[int, np.ndarray] = {}

    def entry_ids(self, ci: int) -> np.ndarray:
        """Entry index of each element of column ``ci`` (nested leaves)."""
        got = self._entry_ids.get(ci)
        if got is not None:
            return got
        chain: List[int] = []
        c = ci
        while self.schema.parent[c] != -1:
            chain.append(self.schema.parent[c])
            c = self.schema.parent[c]
        chain.reverse()  # outermost offset column first
        ids = np.arange(self.n_entries, dtype=np.int64)
        for off in chain:
            ends = self.cols[off]
            sizes = np.diff(ends, prepend=0)
            ids = np.repeat(ids, sizes)
        self._entry_ids[ci] = ids
        return ids

    def reduce_any(self, ci: int, elem_mask: np.ndarray) -> np.ndarray:
        """Existential fold: entry mask from an element mask."""
        out = np.zeros(self.n_entries, dtype=bool)
        hits = np.nonzero(elem_mask)[0]
        if len(hits):
            out[self.entry_ids(ci)[hits]] = True
        return out


# ---------------------------------------------------------------------------
# Expression nodes


class Expr:
    """Base predicate node.  Combine with ``&``, ``|``, ``~``."""

    def __and__(self, other: "Expr") -> "Expr":
        return And((self, _expr(other)))

    def __or__(self, other: "Expr") -> "Expr":
        return Or((self, _expr(other)))

    def __invert__(self) -> "Expr":
        return Not(self)

    # -- interface --------------------------------------------------------

    def fields(self) -> Set[str]:
        """Dotted paths of every leaf field the predicate references."""
        raise NotImplementedError

    def validate(self, schema: Schema) -> None:
        """Check every referenced path is a known leaf column and every
        constant is representable in its column's domain."""
        raise NotImplementedError

    def evaluate(self, ctx: EvalContext) -> np.ndarray:
        """Exact per-entry boolean mask (length ``ctx.n_entries``)."""
        raise NotImplementedError

    def zone_eval(self, zones: Dict[int, Zone]) -> int:
        """Three-valued verdict against per-column zones; a column
        missing from ``zones`` is unconstrained (``T_MAYBE`` atoms)."""
        raise NotImplementedError


def _expr(x) -> "Expr":
    if isinstance(x, Expr):
        return x
    raise TypeError(
        f"expected a filter expression, got {type(x).__name__} "
        "(did you compare a Field with `and`/`or` instead of `&`/`|`?)"
    )


class _Atom(Expr):
    """Shared plumbing for single-field atoms."""

    def __init__(self, path: str):
        self.path = path

    def fields(self) -> Set[str]:
        return {self.path}

    def _col(self, schema: Schema):
        try:
            ci = schema.column_of_path[self.path]
        except KeyError:
            known = ", ".join(
                c.path for c in schema.columns if c.kind == KIND_LEAF
            )
            raise ValueError(
                f"filter references unknown field {self.path!r} "
                f"(leaf fields: {known})"
            ) from None
        col = schema.columns[ci]
        if col.kind != KIND_LEAF:
            raise ValueError(
                f"filter field {self.path!r} is a collection; predicates "
                "apply to leaf fields (e.g. {self.path!r} + '._0')"
            )
        return col

    def _check_value(self, schema: Schema, v) -> None:
        col = self._col(schema)
        if isinstance(v, bool):
            return
        if isinstance(v, int) and col.dtype.kind in "iub":
            info = np.iinfo(col.dtype) if col.dtype.kind != "b" else None
            if info is not None and not (info.min <= v <= info.max):
                raise ValueError(
                    f"constant {v} does not fit column {self.path!r} "
                    f"({col.type}); compare with a float instead"
                )
        elif not isinstance(v, (int, float)):
            raise TypeError(
                f"filter constant for {self.path!r} must be int or float, "
                f"got {type(v).__name__}"
            )


_OPS = {
    "eq": "__eq__",
    "ne": "__ne__",
    "lt": "__lt__",
    "le": "__le__",
    "gt": "__gt__",
    "ge": "__ge__",
}


def _cmp(arr: np.ndarray, op: str, value) -> np.ndarray:
    """Elementwise comparison in the unified numeric domain (float64
    whenever either side is floating — see module docstring)."""
    if isinstance(value, (float, np.floating)) or arr.dtype.kind == "f":
        arr = arr.astype(np.float64, copy=False)
        value = np.float64(value)
    return getattr(arr, _OPS[op])(value)


def _scmp(bound, op: str, value) -> bool:
    """Scalar comparison mirroring :func:`_cmp`'s domain."""
    if isinstance(value, (float, np.floating)) or isinstance(bound, float):
        bound = float(bound)
        value = float(value)
    if op == "eq":
        return bound == value
    if op == "ne":
        return bound != value
    if op == "lt":
        return bound < value
    if op == "le":
        return bound <= value
    if op == "gt":
        return bound > value
    return bound >= value


class Cmp(_Atom):
    """``field <op> constant``."""

    def __init__(self, path: str, op: str, value):
        super().__init__(path)
        if op not in _OPS:
            raise ValueError(f"unknown comparison op {op!r}")
        self.op = op
        self.value = value

    def validate(self, schema: Schema) -> None:
        self._check_value(schema, self.value)

    def evaluate(self, ctx: EvalContext) -> np.ndarray:
        ci = ctx.schema.column_of_path[self.path]
        m = _cmp(ctx.cols[ci], self.op, self.value)
        if ctx.schema.parent[ci] == -1:
            return m
        return ctx.reduce_any(ci, m)

    def zone_eval(self, zones: Dict[int, Zone]) -> int:
        z = zones.get(self.path)
        if z is None:
            return T_MAYBE
        v, op = self.value, self.op
        v_nan = isinstance(v, float) and math.isnan(v)
        if z.count == 0:
            # no elements: a nested atom has no witness; NaN never
            # compares true except via `ne`
            if z.nested:
                return T_FALSE
            return T_MAYBE  # unreachable for top-level zones in practice
        if v_nan:
            # IEEE: only `ne` matches NaN constants (for every value)
            if op == "ne":
                return T_MAYBE if z.nested else T_TRUE
            return T_FALSE
        if z.lo is None:
            # every element is NaN: nothing compares true except `ne`
            if op == "ne":
                return T_MAYBE if z.nested else T_TRUE
            return T_FALSE
        lo, hi, nn = z.lo, z.hi, z.nulls
        if op == "eq":
            if _scmp(v, "lt", lo) or _scmp(v, "gt", hi):
                return T_FALSE
            all_match = (
                nn == 0 and _scmp(lo, "eq", v) and _scmp(hi, "eq", v)
            )
        elif op == "ne":
            # NaN != v is true, so nulls count as matches
            if nn == 0 and _scmp(lo, "eq", v) and _scmp(hi, "eq", v):
                return T_FALSE
            all_match = _scmp(v, "lt", lo) or _scmp(v, "gt", hi)
        elif op in ("gt", "ge"):
            if not _scmp(hi, op, v):
                return T_FALSE
            all_match = nn == 0 and _scmp(lo, op, v)
        else:  # lt, le
            if not _scmp(lo, op, v):
                return T_FALSE
            all_match = nn == 0 and _scmp(hi, op, v)
        if z.nested:
            return T_MAYBE
        return T_TRUE if all_match else T_MAYBE

    def __repr__(self) -> str:
        sym = {"eq": "==", "ne": "!=", "lt": "<", "le": "<=",
               "gt": ">", "ge": ">="}[self.op]
        return f"(F({self.path!r}) {sym} {self.value!r})"


class Between(_Atom):
    """Inclusive range ``low <= field <= high`` (NaN never matches)."""

    def __init__(self, path: str, low, high):
        super().__init__(path)
        self.low = low
        self.high = high

    def validate(self, schema: Schema) -> None:
        self._check_value(schema, self.low)
        self._check_value(schema, self.high)

    def evaluate(self, ctx: EvalContext) -> np.ndarray:
        ci = ctx.schema.column_of_path[self.path]
        arr = ctx.cols[ci]
        m = _cmp(arr, "ge", self.low) & _cmp(arr, "le", self.high)
        if ctx.schema.parent[ci] == -1:
            return m
        return ctx.reduce_any(ci, m)

    def zone_eval(self, zones: Dict[int, Zone]) -> int:
        z = zones.get(self.path)
        if z is None:
            return T_MAYBE
        a, b = self.low, self.high
        if (isinstance(a, float) and math.isnan(a)) or (
            isinstance(b, float) and math.isnan(b)
        ):
            return T_FALSE
        if z.count == 0:
            return T_FALSE if z.nested else T_MAYBE
        if z.lo is None:  # all NaN
            return T_FALSE
        if _scmp(z.hi, "lt", a) or _scmp(z.lo, "gt", b):
            return T_FALSE
        if z.nested:
            return T_MAYBE
        all_match = (
            z.nulls == 0 and _scmp(z.lo, "ge", a) and _scmp(z.hi, "le", b)
        )
        return T_TRUE if all_match else T_MAYBE

    def __repr__(self) -> str:
        return f"F({self.path!r}).between({self.low!r}, {self.high!r})"


class IsNull(_Atom):
    """``field`` is NaN (never true on integer columns)."""

    def validate(self, schema: Schema) -> None:
        self._col(schema)

    def evaluate(self, ctx: EvalContext) -> np.ndarray:
        ci = ctx.schema.column_of_path[self.path]
        arr = ctx.cols[ci]
        if arr.dtype.kind == "f":
            m = np.isnan(arr)
        else:
            m = np.zeros(len(arr), dtype=bool)
        if ctx.schema.parent[ci] == -1:
            return m
        return ctx.reduce_any(ci, m)

    def zone_eval(self, zones: Dict[int, Zone]) -> int:
        z = zones.get(self.path)
        if z is None:
            return T_MAYBE
        if z.nulls == 0:
            return T_FALSE
        if z.nested:
            return T_MAYBE
        return T_TRUE if z.nulls == z.count else T_MAYBE

    def __repr__(self) -> str:
        return f"F({self.path!r}).is_null()"


class NotNull(_Atom):
    """``field`` is a non-NaN value (existential on nested leaves)."""

    def validate(self, schema: Schema) -> None:
        self._col(schema)

    def evaluate(self, ctx: EvalContext) -> np.ndarray:
        ci = ctx.schema.column_of_path[self.path]
        arr = ctx.cols[ci]
        if arr.dtype.kind == "f":
            m = ~np.isnan(arr)
        else:
            m = np.ones(len(arr), dtype=bool)
        if ctx.schema.parent[ci] == -1:
            return m
        return ctx.reduce_any(ci, m)

    def zone_eval(self, zones: Dict[int, Zone]) -> int:
        z = zones.get(self.path)
        if z is None:
            return T_MAYBE
        if z.nulls == z.count:  # all NaN — or no elements at all
            return T_FALSE
        if z.nested:
            return T_MAYBE
        return T_TRUE if z.nulls == 0 else T_MAYBE

    def __repr__(self) -> str:
        return f"F({self.path!r}).not_null()"


class And(Expr):
    def __init__(self, parts: Sequence[Expr]):
        self.parts = tuple(_expr(p) for p in parts)

    def fields(self) -> Set[str]:
        return set().union(*(p.fields() for p in self.parts))

    def validate(self, schema: Schema) -> None:
        for p in self.parts:
            p.validate(schema)

    def evaluate(self, ctx: EvalContext) -> np.ndarray:
        m = self.parts[0].evaluate(ctx)
        for p in self.parts[1:]:
            m = m & p.evaluate(ctx)
        return m

    def zone_eval(self, zones: Dict[int, Zone]) -> int:
        out = T_TRUE
        for p in self.parts:
            t = p.zone_eval(zones)
            if t == T_FALSE:
                return T_FALSE
            if t == T_MAYBE:
                out = T_MAYBE
        return out

    def __repr__(self) -> str:
        return "(" + " & ".join(map(repr, self.parts)) + ")"


class Or(Expr):
    def __init__(self, parts: Sequence[Expr]):
        self.parts = tuple(_expr(p) for p in parts)

    def fields(self) -> Set[str]:
        return set().union(*(p.fields() for p in self.parts))

    def validate(self, schema: Schema) -> None:
        for p in self.parts:
            p.validate(schema)

    def evaluate(self, ctx: EvalContext) -> np.ndarray:
        m = self.parts[0].evaluate(ctx)
        for p in self.parts[1:]:
            m = m | p.evaluate(ctx)
        return m

    def zone_eval(self, zones: Dict[int, Zone]) -> int:
        out = T_FALSE
        for p in self.parts:
            t = p.zone_eval(zones)
            if t == T_TRUE:
                return T_TRUE
            if t == T_MAYBE:
                out = T_MAYBE
        return out

    def __repr__(self) -> str:
        return "(" + " | ".join(map(repr, self.parts)) + ")"


class Not(Expr):
    def __init__(self, child: Expr):
        self.child = _expr(child)

    def fields(self) -> Set[str]:
        return self.child.fields()

    def validate(self, schema: Schema) -> None:
        self.child.validate(schema)

    def evaluate(self, ctx: EvalContext) -> np.ndarray:
        return ~self.child.evaluate(ctx)

    def zone_eval(self, zones: Dict[int, Zone]) -> int:
        return _not3(self.child.zone_eval(zones))

    def __repr__(self) -> str:
        return f"~{self.child!r}"


# ---------------------------------------------------------------------------
# Field handle: the user-facing entry point


class Field:
    """Handle for building predicates over one leaf field path.

    Comparison operators produce :class:`Expr` nodes (so ``==`` does NOT
    test Field identity); combine the results with ``&``/``|``/``~``.
    """

    __slots__ = ("path",)

    def __init__(self, path: str):
        self.path = path

    def __eq__(self, other):  # type: ignore[override]
        return Cmp(self.path, "eq", other)

    def __ne__(self, other):  # type: ignore[override]
        return Cmp(self.path, "ne", other)

    def __lt__(self, other):
        return Cmp(self.path, "lt", other)

    def __le__(self, other):
        return Cmp(self.path, "le", other)

    def __gt__(self, other):
        return Cmp(self.path, "gt", other)

    def __ge__(self, other):
        return Cmp(self.path, "ge", other)

    __hash__ = None  # type: ignore[assignment]

    def between(self, low, high) -> Between:
        return Between(self.path, low, high)

    def is_null(self) -> IsNull:
        return IsNull(self.path)

    def not_null(self) -> NotNull:
        return NotNull(self.path)

    def __repr__(self) -> str:
        return f"F({self.path!r})"


F = Field


# ---------------------------------------------------------------------------
# Helpers shared by the reader's prune planner


def required_columns(schema: Schema, expr: Expr) -> List[int]:
    """Column indices a predicate needs decoded: every referenced leaf
    plus the offset-column chain above each nested leaf (entry
    attribution), in schema order (parents before children)."""
    need: Set[int] = set()
    for path in expr.fields():
        ci = schema.column_of_path.get(path)
        if ci is None:
            raise ValueError(f"filter references unknown field {path!r}")
        need.add(ci)
        p = schema.parent[ci]
        while p != -1:
            need.add(p)
            p = schema.parent[p]
    return sorted(need)


def filter_paths(schema: Schema, expr: Expr) -> Dict[str, int]:
    """path -> leaf column index for every field the predicate tests."""
    return {p: schema.column_of_path[p] for p in expr.fields()}
