"""The port's CSV typing and flat YAML reader against pandas and PyYAML,
the two readers the JAX package uses (ROADMAP C.1 and C.2).

C.1: each witness column is read by ``pandas.read_csv`` and by the port's
``read_csv``; the typed columns must agree (dtype and every cell), and
``prepare_table`` must give JAX's widths and arrays exactly.  A seeded
fuzz of 250 CSVs over numbers, missing-value strings, letter strings,
boolean literals and integers beyond int64 holds the same equality.

C.2: every tab outside a quoted scalar or a comment raises ``ValueError``
where ``yaml.safe_load`` raises; tabs inside quotes and comments read as
PyYAML reads them.
"""

import math

import numpy as np
import pandas as pd
import pytest
import yaml

from gfe_mamba_tpu.data.table import prepare_table as jax_prepare_table
from gfe_mamba_torch.config import parse_nested_yaml, parse_yaml
from gfe_mamba_torch.data.table import prepare_table, read_csv

B = "9999999999999999999"           # above int64, within uint64
N = "-9999999999999999999"          # below int64
H = "99999999999999999999999"       # above uint64

# (name, cells): each becomes a column beside an int column, so that a
# blank cell is a gap and not a blank line.
WITNESS_COLUMNS = [
    ("bool_gap", ["True", "", "False"]),
    ("bool_gap_cases", ["TRUE", "NA", "true", "false"]),
    ("bool_no_gap", ["True", "FALSE", "true"]),
    ("bool_and_int", ["True", "", "1"]),
    ("bool_and_float", ["True", "1.0", ""]),
    ("bool_and_letters", ["True", "None", "abc"]),
    ("all_missing", ["", "NA"]),
    ("uint64", [B, "1", "+5"]),
    ("uint64_gap", [B, "", "1"]),
    ("uint64_na_string", [B, "NA"]),
    ("uint64_negative", [B, "-1"]),
    ("uint64_float", [B, "1.5"]),
    ("uint64_inf_gap", [B, "NA", "inf"]),
    ("uint64_neg_inf", [B, "-inf"]),
    ("below_int64", [N, "1", ""]),
    ("below_int64_float", [N, "1.5"]),
    ("above_uint64", [H, "", "3"]),
    ("above_uint64_then_float", [H, "1.5", "NA"]),
    ("float_then_above_uint64", ["1.5", H, ""]),
    ("above_and_below", [H, N]),
    ("int_then_big_then_letters", ["1", B, "abc"]),
]


def _write(path, columns):
    n = max(len(cells) for _, cells in columns)
    lines = [",".join(["PTID", "MMSE"] + [name for name, _ in columns])]
    for i in range(n):
        row = [f"p{i}", str(20 + i)]
        row += [cells[i] if i < len(cells) else "" for _, cells in columns]
        lines.append(",".join(row))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _same_cell(got, want) -> bool:
    if got is None:
        return isinstance(want, float) and math.isnan(want)
    if isinstance(want, float) and math.isnan(want):
        return isinstance(got, float) and math.isnan(got)
    return type(got) is type(want) and got == want


def _assert_column_as_pandas(table, frame, name):
    got, want = table.data[name], frame[name]
    if isinstance(got, list):           # an object column
        assert want.dtype == object or pd.api.types.is_string_dtype(want), \
            (name, want.dtype)
        cells = want.tolist()
        assert len(got) == len(cells)
        assert all(_same_cell(g, w) for g, w in zip(got, cells)), \
            (name, got, cells)
    else:
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want.to_numpy())


def _assert_prepared_as_jax(path):
    want = jax_prepare_table(pd.read_csv(path))
    got = prepare_table(read_csv(path))
    assert got["num_cat"] == want["num_cat"]
    assert got["num_cont"] == want["num_cont"]
    assert got["preprocessor"].to_json() == want["preprocessor"].to_json()
    np.testing.assert_array_equal(got["cate_x"], want["cate_x"])
    np.testing.assert_array_equal(got["conti_x"], want["conti_x"])


def test_boolean_column_with_a_gap_is_numeric_as_in_jax(tmp_path):
    """ROADMAP C.1's witness: ``APOE_pos`` True, (blank), False beside an
    int ``MMSE`` and ``label``: JAX standardises all three columns."""
    path = tmp_path / "witness.csv"
    path.write_text("PTID,APOE_pos,MMSE,label\n"
                    "a,True,27,0\nb,,22,1\nc,False,30,0\n")
    want = jax_prepare_table(pd.read_csv(path))
    assert want["num_cat"] == [] and want["num_cont"] == 3
    _assert_prepared_as_jax(str(path))
    col = read_csv(str(path)).data["APOE_pos"]
    assert col == [True, None, False]


@pytest.mark.filterwarnings("ignore::RuntimeWarning")   # inf - inf
@pytest.mark.parametrize("name,cells", WITNESS_COLUMNS,
                         ids=[n for n, _ in WITNESS_COLUMNS])
def test_column_types_as_pandas(tmp_path, name, cells):
    path = _write(tmp_path / "c.csv", [(name, cells)])
    _assert_column_as_pandas(read_csv(path), pd.read_csv(path), name)
    _assert_prepared_as_jax(path)


FUZZ_CLASSES = {
    "int": ["1", "-2", "0", " 4 ", "+5", "-0", "12"],
    "float": ["1.5", "-2.25", "1e3", "inf", "-inf", ".5"],
    "missing": ["", "NA", "nan", "None", "null", "N/A"],
    "letters": ["abc", "Male", "x1", "b3"],
    "bool": ["True", "False", "TRUE", "true", "FALSE", "false"],
    "big": [B, N, H, "18446744073709551615"],
}


def _fuzz_columns(rng):
    rows = int(rng.integers(2, 7))
    columns = []
    for j in range(int(rng.integers(1, 5))):
        kinds = rng.choice(list(FUZZ_CLASSES), size=int(rng.integers(1, 4)),
                           replace=False)
        cells = [str(rng.choice(FUZZ_CLASSES[str(rng.choice(kinds))]))
                 for _ in range(rows)]
        columns.append((f"c{j}", cells))
    return columns


@pytest.mark.filterwarnings("ignore::RuntimeWarning")   # inf - inf
def test_fuzzed_csvs_type_and_prepare_as_pandas(tmp_path):
    """250 seeded CSVs: every column typed as pandas types it, and
    ``prepare_table`` equal to JAX's on each."""
    rng = np.random.default_rng(16)
    for case in range(250):
        columns = _fuzz_columns(rng)
        path = _write(tmp_path / f"f{case}.csv", columns)
        table, frame = read_csv(path), pd.read_csv(path)
        for name, _ in columns:
            _assert_column_as_pandas(table, frame, name)
        _assert_prepared_as_jax(path)


TAB_CASES = [
    "a: x\t", "a: x\t  # c", "a: x \t", "a: x\t \t", "a: x\t# c",
    "a: 1\t", "a: true\t", "a: null\t", "a:\tx", "a:\t", "a: x\ty",
    "a: 'x'\t", "a: \"x\" \t", "a: [1, 2]\t", "a: [1,\t2]", "a: [x\t, y]",
    "a\t: x", "'a'\t: x", "a: 1\n\t\nb: 2", "\t# c\na: 1", "---\t\na: 1",
    "a: x\t\nb: 1",
]
TAB_KEPT = ["a: 'x\ty'", "a: \"x\ty\" # c", "a: x # c\td", "# c\td\na: 1",
            "a: x  # c\t"]


@pytest.mark.parametrize("text", TAB_CASES)
@pytest.mark.parametrize("reader", [parse_yaml, parse_nested_yaml],
                         ids=["flat", "nested"])
def test_tab_outside_quotes_and_comments_raises_as_pyyaml(reader, text):
    with pytest.raises(yaml.YAMLError):
        yaml.safe_load(text)
    with pytest.raises(ValueError):
        reader(text)


@pytest.mark.parametrize("text", TAB_KEPT)
def test_tab_inside_quotes_and_comments_reads_as_pyyaml(text):
    assert parse_yaml(text) == yaml.safe_load(text)
    assert parse_nested_yaml(text) == yaml.safe_load(text)
