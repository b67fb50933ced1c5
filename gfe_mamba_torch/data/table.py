"""Tabular clinical-scale preprocessing (counterpart of
``gfe_mamba_tpu/data/table.py``) on ``csv`` and numpy instead of pandas.

``read_csv`` reads a CSV as ``pandas.read_csv`` does with its defaults,
as far as ``prepare_table`` and the datasets can tell:

* pandas' NA strings (``""``, ``NA``, ``N/A``, ``NaN``, ``nan``,
  ``null``, ``None``, ...) are missing values;
* a column whose present cells are all integers (spaces around them
  allowed) and which has no missing cell is int64; one whose present
  cells all parse as numbers (an int column with a gap, ``1e5``, ``.5``,
  ``inf``) is float64 with NaN for the gaps; one of only
  ``True/TRUE/true/False/FALSE/false`` is bool, or with a gap an object
  column of bools with None for the gaps; an empty one is float64; any
  other is an object column of strings with None for the gaps;
* integers beyond int64 take pandas' overflow detour
  (``_infer_overflow``): uint64, Python ints, or the cells as written
  with their missing-value strings, by the order and kinds of the cells;
* blank lines are skipped, short rows padded with missing cells, and a
  repeated header name ``X`` becomes ``X.1``, ``X.2``.

``prepare_table`` then drops the identifier and leakage columns, takes
the object columns holding a letter as categoricals (vocabulary: the
sorted strings, a gap being ``"NA"``) and standardises the rest
(``to_numeric`` with gaps and unparseable cells at 0, mean and
population std computed as pandas' ``nanops`` does, a zero or NaN std
taken as 1).
"""

from __future__ import annotations

import csv
import json
import math
import re
from dataclasses import dataclass, field

import numpy as np

DROP_LIST = ["RID", "D2", "SITE", "DX", "COLPROT", "ORIGPROT", "Month",
             "M", "FDG", "PIB", "AV45"]
INFO_LIST = ["PTID", "EXAMDATE", "LABEL"]
NA_STRINGS = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))
_TRUE = ("True", "TRUE", "true")
_FALSE = ("False", "FALSE", "false")
_INT_RE = re.compile(r"^[ \t]*[-+]?[0-9]+[ \t]*$")
_FLOAT_RE = re.compile(r"""^[ \t]*[-+]?(?:[0-9]+\.?[0-9]*|\.[0-9]+)
                       (?:[eE][-+]?[0-9]+)?[ \t]*$""", re.X)
_INF_RE = re.compile(r"^[ \t]*([-+]?)(?:inf|infinity)[ \t]*$", re.I)


_POW10 = [float(f"1e{k}") for k in range(309)]


def xstrtod(text: str) -> float:
    """pandas' default float converter (``precise_xstrtod`` of its C
    parser, which ``read_csv`` and ``to_numeric`` share) on a cell that
    matches ``_FLOAT_RE``: up to 17 significant digits accumulated as
    ``number * 10 + digit`` in doubles, then one multiplication or
    division by a power of ten.  It is not always correctly rounded
    (``float()`` is), and the table's mean and std must be pandas'."""
    s, p = text.strip(" \t"), 0
    negative = s[0] == "-"
    if s[0] in "+-":
        p = 1
    number, exponent, digits = 0.0, 0, 0
    while p < len(s) and s[p].isdigit():
        if digits < 17:
            number = number * 10.0 + (ord(s[p]) - 48)
            digits += 1
        else:
            exponent += 1
        p += 1
    if p < len(s) and s[p] == ".":
        p += 1
        while p < len(s) and s[p].isdigit():
            if digits < 17:
                number = number * 10.0 + (ord(s[p]) - 48)
                digits += 1
                exponent -= 1
            p += 1
    if negative:
        number = -number
    if p < len(s):                                 # [eE][-+]?digits
        exponent += int(s[p + 1:])
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return 0.0
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _to_float(text: str) -> float:
    """A cell as a float, NaN when it is not a number (``to_numeric``'s
    ``errors="coerce"``)."""
    if _FLOAT_RE.match(text):
        return xstrtod(text)
    inf = _INF_RE.match(text)
    if inf:
        return -math.inf if inf.group(1) == "-" else math.inf
    return math.nan


class Table:
    """A parsed CSV: ``columns`` in file order and ``data[name]``, an int64,
    float64 or bool numpy array, or a list of str/None (object)."""

    def __init__(self, columns: list, data: dict):
        self.columns = list(columns)
        self.data = data

    def __len__(self) -> int:
        return len(self.data[self.columns[0]]) if self.columns else 0

    def is_object(self, name: str) -> bool:
        return isinstance(self.data[name], list)

    def cell(self, row: int, name: str):
        """One cell as the frame's ``iloc[row][name]`` gives it: a numpy
        scalar, a str, or NaN for a gap in an object column."""
        value = self.data[name][row]
        return math.nan if value is None else value

    def as_str(self, name: str) -> list:
        """``df[name].fillna("NA").astype(str)``."""
        col = self.data[name]
        if isinstance(col, list):
            return ["NA" if v is None else str(v) for v in col]
        if col.dtype.kind == "f":
            return ["NA" if math.isnan(v) else str(v) for v in col.tolist()]
        return [str(v) for v in col.tolist()]

    def numeric(self, name: str) -> np.ndarray:
        """``pd.to_numeric(df[name], errors="coerce").fillna(0)`` as
        float64 (int and bool cells keep their values)."""
        col = self.data[name]
        if isinstance(col, list):
            out = np.asarray([math.nan if v is None else
                              _to_float(v) if isinstance(v, str) else
                              float(v) for v in col], np.float64)
        else:
            out = col.astype(np.float64)
        return np.where(np.isnan(out), 0.0, out)


_I64_MIN, _I64_MAX, _U64_MAX = -2 ** 63, 2 ** 63 - 1, 2 ** 64 - 1


def _as_int(cell: str):
    """An integer cell's value, None for any other cell.  A value beyond
    int64 with trailing spaces is no integer to pandas' parser."""
    if not _INT_RE.match(cell):
        return None
    value = int(cell)
    if not _I64_MIN <= value <= _I64_MAX and cell != cell.rstrip(" \t"):
        return None
    return value


def _infer(raw: list):
    """One column as pandas' C parser types it, from its cells as written:
    the int64, float64, bool and object attempts in turn, with its
    overflow detour through uint64 (``_infer_overflow``)."""
    cells = [None if c in NA_STRINGS else c for c in raw]
    present = [c for c in cells if c is not None]
    if not present:
        return np.full(len(cells), np.nan)
    for c in present:                 # the int64 attempt, row by row
        value = _as_int(c)
        if value is None:
            break
        if not _I64_MIN <= value <= _I64_MAX:
            typed = _infer_overflow(raw, cells)
            if typed is not None:
                return typed
            break
    else:
        if len(present) == len(cells):
            return np.asarray([int(c) for c in cells], np.int64)
    if all(_FLOAT_RE.match(c) or _INF_RE.match(c) for c in present):
        return np.asarray([math.nan if c is None else _to_float(c)
                           for c in cells], np.float64)
    if all(c in _TRUE or c in _FALSE for c in present):
        if len(present) == len(cells):
            return np.asarray([c in _TRUE for c in cells], bool)
        return [None if c is None else c in _TRUE for c in cells]
    return cells


def _infer_overflow(raw: list, cells: list):
    """pandas' uint64 attempt after an int64 overflow: uint64 when it
    holds; the cells as written (missing-value strings included) when a
    value above int64 meets a negative or a gap; Python ints, or the
    cells as written where one is no integer, when a value lies beyond
    uint64 or a negative stands alone; None (on to float64) at the first
    other cell."""
    seen_uint = seen_sint = seen_null = False
    for c in cells:
        if c is None:
            seen_null = True
        elif c.lstrip(" \t").startswith("-"):
            seen_sint = True          # pandas reads no further
        else:
            value = _as_int(c)
            if value is None:
                return None
            if value > _U64_MAX:
                return _overflow_objects(raw, cells)
            seen_uint = seen_uint or value > _I64_MAX
    if seen_uint and (seen_sint or seen_null):
        return list(raw)
    if seen_sint:
        return _overflow_objects(raw, cells)
    return np.asarray([int(c) for c in cells], np.uint64)


def _overflow_objects(raw: list, cells: list):
    if all(c is None or _INT_RE.match(c) for c in cells):
        return [None if c is None else int(c) for c in cells]
    return list(raw)


def read_csv(path: str) -> Table:
    """The CSV at ``path`` as ``pandas.read_csv(path)`` types it."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = [r for r in csv.reader(f)
                if r and not (len(r) == 1 and not r[0].strip())]
    if not rows:
        raise ValueError(f"{path}: no header")
    header, seen = [], {}
    for name in rows[0]:
        if name in seen:
            seen[name] += 1
            name = f"{name}.{seen[name]}"
        seen.setdefault(name, 0)
        header.append(name)
    width = len(header)
    cells = [[] for _ in header]
    for lineno, row in enumerate(rows[1:], 2):
        if len(row) > width:
            raise ValueError(f"{path}:{lineno}: {len(row)} fields, the "
                             f"header has {width}")
        row = row + [""] * (width - len(row))
        for j, value in enumerate(row):
            cells[j].append(value)
    return Table(header, {name: _infer(col)
                          for name, col in zip(header, cells)})


def has_letters(value) -> bool:
    return isinstance(value, str) and re.search(r"[a-zA-Z]", value) is not None


def discover_mixed_columns(table: Table, columns: list) -> list:
    """Object columns holding at least one letter-bearing string."""
    return [c for c in columns if table.is_object(c)
            and any(has_letters(v) for v in table.data[c])]


def _nan_mean_std(values: np.ndarray) -> tuple[float, float]:
    """pandas' ``nanops.nanmean`` and ``nanstd(ddof=0)`` on a gap-free
    float64 column."""
    count = values.size
    avg = values.sum(dtype=np.float64) / count
    var = ((avg - values) ** 2).sum(dtype=np.float64) / count
    return float(avg), float(np.sqrt(var))


@dataclass
class TablePreprocessor:
    """Fitted, serializable transform: categorical vocabularies +
    numeric standardization stats (the JAX class's JSON, field for
    field)."""

    cat_columns: list = field(default_factory=list)
    num_columns: list = field(default_factory=list)
    cat_vocabs: dict = field(default_factory=dict)
    num_mean: dict = field(default_factory=dict)
    num_std: dict = field(default_factory=dict)

    @property
    def num_cat(self) -> list[int]:
        return [len(self.cat_vocabs[c]) for c in self.cat_columns]

    @property
    def num_cont(self) -> int:
        return len(self.num_columns)

    def fit(self, table: Table, columns: list) -> "TablePreprocessor":
        self.cat_columns = discover_mixed_columns(table, columns)
        self.num_columns = [c for c in columns if c not in self.cat_columns]
        for col in self.cat_columns:
            self.cat_vocabs[col] = sorted(set(table.as_str(col)))
        for col in self.num_columns:
            mean, std = _nan_mean_std(table.numeric(col))
            self.num_mean[col] = mean
            self.num_std[col] = std if std > 0 else 1.0
        return self

    def transform(self, table: Table):
        n = len(table)
        cate = np.zeros((n, len(self.cat_columns)), np.int64)
        for j, col in enumerate(self.cat_columns):
            vocab = {v: i for i, v in enumerate(self.cat_vocabs[col])}
            cate[:, j] = [vocab.get(v, 0) for v in table.as_str(col)]
        conti = np.zeros((n, len(self.num_columns)), np.float32)
        for j, col in enumerate(self.num_columns):
            conti[:, j] = ((table.numeric(col) - self.num_mean[col])
                           / self.num_std[col]).astype(np.float32)
        return cate, conti

    def to_json(self) -> str:
        return json.dumps({
            "cat_columns": self.cat_columns,
            "num_columns": self.num_columns,
            "cat_vocabs": self.cat_vocabs,
            "num_mean": self.num_mean,
            "num_std": self.num_std,
        })

    @classmethod
    def from_json(cls, text: str) -> "TablePreprocessor":
        return cls(**json.loads(text))


def prepare_table(table: Table,
                  preprocessor: TablePreprocessor | None = None) -> dict:
    """JAX ``prepare_table``'s contract: {info, cate_x, conti_x, num_cat,
    num_cont, preprocessor}; ``info`` maps each of PTID/EXAMDATE/LABEL
    present to its column.  Pass a fitted preprocessor to reuse train-time
    encoders."""
    drop = set(DROP_LIST) | set(INFO_LIST) \
        | {c for c in table.columns if "bl" in c}
    body = [c for c in table.columns if c not in drop]
    if preprocessor is None:
        preprocessor = TablePreprocessor().fit(table, body)
    cate_x, conti_x = preprocessor.transform(table)
    return {
        "info": {c: table.data[c] for c in INFO_LIST if c in table.columns},
        "cate_x": cate_x,
        "conti_x": conti_x,
        "num_cat": preprocessor.num_cat,
        "num_cont": preprocessor.num_cont,
        "preprocessor": preprocessor,
    }
