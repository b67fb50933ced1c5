"""The port's config reader, table, datasets, loader, synthetic trees and
PNG writer against the JAX package's (PyYAML, pandas and PIL on this
side only), and the port's freedom from all three.

Exact equality throughout: the config dicts, the fitted table transform
(its JSON), the encoded arrays (NaN where JAX has NaN), every batch of
two shuffled epochs, the decoded volumes and the PNG's pixels.
"""

import io
import os
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd
import pytest

from gfe_mamba_tpu.config import load_config as jax_load_config
from gfe_mamba_tpu.data import datasets as jax_datasets
from gfe_mamba_tpu.data import synthetic as jax_synthetic
from gfe_mamba_tpu.data.nifti import load_nifti as jax_load_nifti
from gfe_mamba_tpu.data.table import prepare_table as jax_prepare_table
from gfe_mamba_torch.config import (ClassifyConfig, GanVitConfig, load_config,
                                    parse_yaml)
from gfe_mamba_torch.data import datasets, synthetic
from gfe_mamba_torch.data.table import prepare_table, read_csv, xstrtod
from gfe_mamba_torch.utils.experiment import save_volume_grid, volume_grid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.join(REPO, "configs", f)
                 for f in os.listdir(os.path.join(REPO, "configs"))
                 if f.endswith(".yaml"))
SHAPE = (16, 16, 8)


def _test_configs():
    from tests.test_autoresume_cli import _CONFIG
    return {"autoresume_cli": _CONFIG.format(train="/d/train",
                                             eval="/d/eval", proj="/d/w")}


SCALARS = textwrap.dedent("""\
    # every resolver case the configs could meet
    f1: 1.0e-4
    f2: 1e-4
    f3: .5
    f4: -1.5E+3
    f5: 6.02e23
    f6: 1_000.5
    f7: -.inf
    i1: 010
    i2: 0x1F
    i3: 0b101
    i4: 1_000
    i5: 1:30
    i6: -0
    i7: 09
    b1: yes
    b2: Off
    b3: TRUE
    b4: yEs
    n1: ~
    n2: null
    n3:
    s1: 'ct_2&5_1year.csv'
    s2: "tab\\there"
    s3: 'it''s'
    s4: plain text # a comment
    s5: a#b
    s6: http://host:80/x
    d1: 2006-03-01
    l1: [64, 128, 256]
    l2: ['a', b, 1.0e-3, ~, no]
    l3: []
    'quoted key': 1
    """)


def _same(a, b) -> bool:
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("name", [os.path.basename(c) for c in CONFIGS]
                         + ["autoresume_cli", "scalars"])
def test_load_config_equals_safe_load(name, tmp_path):
    if name == "scalars":
        text = SCALARS
    elif name in _test_configs():
        text = _test_configs()[name]
    else:
        text = open(os.path.join(REPO, "configs", name)).read()
    path = tmp_path / "c.yaml"
    path.write_text(text)
    want = jax_load_config(str(path))
    got = load_config(str(path))
    assert list(got) == list(want)
    for key in want:
        assert _same(got[key], want[key]), (key, got[key], want[key])
    if name.startswith("main_gan"):
        assert GanVitConfig.from_yaml(str(path)).f_maps == (64, 128, 256)
    elif name.startswith("classify"):
        assert ClassifyConfig.from_yaml(str(path)).lr == 1e-4


@pytest.mark.parametrize("text", [
    "a:\n  b: 1\n",                 # nested mapping
    "a:\n- 1\n- 2\n",               # block list
    "a: &x 1\nb: *x\n",             # anchor, alias
    "a: !!str 1\n",                 # tag
    "a: |\n  text\n",               # block scalar
    "a: 'multi\n  line'\n",         # multi-line scalar
    "a: {b: 1}\n",                  # flow mapping
    "a: b: c\n",                    # nested on one line
])
def test_parse_yaml_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        parse_yaml(text)


EDGE_CSV = textwrap.dedent("""\
    PTID,EXAMDATE,LABEL,RID,A,B,C,D,E,F,G,H,I,J,date_diff,ABETA_bl
    x1,2006-03-01,1,1,1,1.5, 12 ,True,a,NA,inf,1e5,007,"1,000",5,q
    x2,2006-03-02,0,2,2,,13,False,,N/A,-inf,+5,-3, 3 ,nan,r

    x3,nan,1,3,3,2.5,null,True,b3,n/a,Infinity,0x10,12,1_000,-1,s
    x4,2006-03-04,,4,4,3.5,14,False,Male,,1,7,5,,NA,t
    """)


def _table_case(tmp_path, which):
    if which == "synthetic":
        return synthetic.make_classify_tree(str(tmp_path), n_items=5,
                                            shape=SHAPE)[1]
    path = tmp_path / "edge.csv"
    path.write_text(EDGE_CSV)
    return str(path)


@pytest.mark.parametrize("which", ["synthetic", "edge"])
def test_prepare_table_equals_jax(tmp_path, which):
    path = _table_case(tmp_path, which)
    want = jax_prepare_table(pd.read_csv(path))
    got = prepare_table(read_csv(path))
    assert got["preprocessor"].to_json() == want["preprocessor"].to_json()
    assert got["num_cat"] == want["num_cat"]
    assert got["num_cont"] == want["num_cont"]
    np.testing.assert_array_equal(got["cate_x"], want["cate_x"])
    assert got["cate_x"].dtype == want["cate_x"].dtype
    np.testing.assert_array_equal(got["conti_x"], want["conti_x"])
    assert got["conti_x"].dtype == want["conti_x"].dtype


def test_float_cells_parse_as_pandas_does():
    """pandas' converter rounds about a third of 17-digit cells otherwise
    than ``float()``; the port's ``xstrtod`` takes the same double."""
    rng = np.random.default_rng(0)
    cells = ([repr(float(x)) for x in rng.uniform(0, 100, 3000)]
             + [f"{x:.20g}" for x in rng.uniform(-1e6, 1e6, 1000)]
             + ["1e5", " 12 ", "+.5", "5.", "-0.0", "1.5e-300", "5e-324",
                "123456789012345678901234", "1E+400"])
    want = pd.read_csv(io.StringIO("x\n" + "\n".join(cells)))["x"]
    np.testing.assert_array_equal([xstrtod(c) for c in cells],
                                  want.to_numpy())


def _classify_tree_with_date_diff(root: str):
    """Six items whose CSV rows carry a date_diff (one at the threshold,
    one NaN), plus a row whose LABEL is missing."""
    vol_dir, csv_path = synthetic.make_classify_tree(root, n_items=6,
                                                     shape=SHAPE, seed=2)
    lines = open(csv_path).read().splitlines()
    diffs = ["date_diff", "30", "-1", "", "400", "0", "12", "5", "6", "7",
             "8"]
    lines = [f"{line},{d}" for line, d in zip(lines, diffs)]
    lines.append("000_S_1000,2006-03-01,,0,1,70.0,25.0,20.0,1,Male,"
                 "Married,LMCI,3")
    with open(csv_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return vol_dir, csv_path


def test_classify_dataset_rows_equal_jax(tmp_path):
    vol_dir, csv_path = _classify_tree_with_date_diff(str(tmp_path))
    for threshold in (-1, 0, 29):
        want = jax_datasets.MRIClassifyDataset(vol_dir, csv_path, SHAPE,
                                               days_threshold=threshold)
        got = datasets.MRIClassifyDataset(vol_dir, csv_path, SHAPE,
                                          days_threshold=threshold)
        assert got.items == [(p, int(r)) for p, r in want.items]
        assert got.num_cat == want.num_cat
        assert got.num_cont == want.num_cont
    for i in range(len(got)):
        a, b = got[i], want[i]
        for key in ("image", "label", "cate_x", "conti_x", "name"):
            np.testing.assert_array_equal(a[key], b[key])


def test_loaders_give_jax_batches_in_order(tmp_path):
    """Two shuffled epochs of each dataset, both packages, batch 2."""
    mri_root = str(tmp_path / "pairs")
    synthetic.make_mri2pet_tree(mri_root, n_subjects=5, shape=SHAPE)
    vol_dir, csv_path = synthetic.make_classify_tree(
        str(tmp_path / "cls"), n_items=5, shape=SHAPE)
    loaders = [
        (datasets.form_dataloader(mri_root, SHAPE, 2, seed=3),
         jax_datasets.form_dataloader(mri_root, SHAPE, 2, seed=3)),
        (datasets.classi_dataloader(vol_dir, SHAPE, 2, csv_path, seed=3),
         jax_datasets.classi_dataloader(vol_dir, SHAPE, 2, csv_path,
                                        seed=3)),
    ]
    for got_loader, want_loader in loaders:
        for _ in range(2):
            got, want = list(got_loader), list(want_loader)
            assert len(got) == len(want) == 2
            for a, b in zip(got, want):
                assert set(a) == set(b)
                for key in a:
                    np.testing.assert_array_equal(a[key], b[key])
        assert got_loader.batches == 4


def test_synthetic_trees_decode_to_jax_arrays(tmp_path):
    port_pairs = synthetic.make_mri2pet_tree(str(tmp_path / "p"), 2, SHAPE,
                                             seed=4)
    jax_pairs = jax_synthetic.make_mri2pet_tree(str(tmp_path / "j"), 2,
                                                SHAPE, seed=4)
    for sub in sorted(os.listdir(jax_pairs)):
        for name in ("mri.nii.gz", "pet.nii.gz"):
            np.testing.assert_array_equal(
                jax_load_nifti(os.path.join(port_pairs, sub, name))[0],
                jax_load_nifti(os.path.join(jax_pairs, sub, name))[0])
    p_dir, p_csv = synthetic.make_classify_tree(str(tmp_path / "pc"), 3,
                                                SHAPE, seed=4)
    j_dir, j_csv = jax_synthetic.make_classify_tree(str(tmp_path / "jc"), 3,
                                                    SHAPE, seed=4)
    assert sorted(os.listdir(p_dir)) == sorted(os.listdir(j_dir))
    for name in os.listdir(j_dir):
        np.testing.assert_array_equal(
            jax_load_nifti(os.path.join(p_dir, name))[0],
            jax_load_nifti(os.path.join(j_dir, name))[0])
    assert open(p_csv).read() == open(j_csv).read()


def test_python_and_native_codecs_agree(tmp_path, monkeypatch):
    vol_dir, csv_path = synthetic.make_classify_tree(str(tmp_path), 2, SHAPE)
    native = datasets.MRIClassifyDataset(vol_dir, csv_path, (12, 20, 6))
    before = dict(datasets.CODEC_RUNS)
    a = native[0]["image"]
    monkeypatch.setenv("GFE_NATIVE_IO", "0")
    b = datasets.MRIClassifyDataset(vol_dir, csv_path, (12, 20, 6))[0]
    assert datasets.CODEC_RUNS["python"] == before.get("python", 0) + 1
    np.testing.assert_allclose(a, b["image"], atol=1e-5)


def test_png_decodes_to_volume_grid(tmp_path):
    from PIL import Image
    rng = np.random.RandomState(0)
    vol = rng.uniform(-1.2, 1.2, (1, 12, 10, 11, 1)).astype(np.float32)
    path = str(tmp_path / "grid.png")
    save_volume_grid(vol, path)
    want = (volume_grid(vol) * 255).astype(np.uint8)
    with Image.open(path) as im:
        assert im.mode == "L"
        np.testing.assert_array_equal(np.asarray(im), want)


_BLOCKED = ("jax", "jaxlib", "flax", "optax", "gfe_mamba_tpu", "pandas",
            "yaml", "PIL", "orbax", "tensorboardX")


def test_port_imports_none_of_jax_pandas_yaml_pil_orbax():
    """Every port module imports with those packages made unimportable."""
    script = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        for name in {_BLOCKED!r}:
            sys.modules[name] = None
        sys.path.insert(0, {REPO!r})
        import gfe_mamba_torch
        names = [m.name for m in pkgutil.walk_packages(
            gfe_mamba_torch.__path__, "gfe_mamba_torch.")]
        for name in names:
            importlib.import_module(name)
        print(len(names))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 30
