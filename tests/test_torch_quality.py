"""``quality_torch.py`` on the CPU: the canonical cohort's synthesis
against ``tools/canonical_convergence.py::make_synth`` given JAX's own
draws (within 1e-6), the draws' law, and a ``--smoke`` run of each
geometry writing a well-formed, finite artifact.

The full runs train for many epochs and run on the card; their
artifacts are ``QUALITY_torch.json`` and ``CANONICAL_torch.json``.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quality_torch
from tools.canonical_convergence import make_synth

SHAPE = (32, 32, 16)


def _jax_draws(seed, idxs, hard):
    """The noise and the phenotype flip ``make_synth`` draws for each
    subject: ``fold_in(key(7000 + seed), idx)`` split into the noise key
    and the flip key."""
    express_p = 0.15 if hard else 0.0
    noise, flip = [], []
    for idx in idxs:
        key = jax.random.fold_in(jax.random.key(7000 + seed), idx)
        kn, ke = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(kn, SHAPE, jnp.float32)))
        flip.append(float(jax.random.uniform(ke, ()) < express_p))
    return np.stack(noise), np.asarray(flip, np.float32)


@pytest.mark.parametrize("hard", [True, False])
def test_synthesis_given_jax_draws_equals_make_synth(hard):
    seed = 0
    idxs = np.arange(40)
    noise, flip = _jax_draws(seed, idxs, hard)
    if hard:                         # both phenotypes, both flips
        assert 0 < flip.sum() < len(flip)
    labels = (idxs % 2).astype(np.float32)
    want_mri, want_pet = make_synth(SHAPE, seed, hard=hard)(
        jnp.asarray(idxs), jnp.asarray(labels))
    mri, pet = quality_torch.synth_volumes(
        torch.from_numpy(noise), torch.from_numpy(flip),
        torch.from_numpy(labels), hard=hard)
    assert mri.shape == pet.shape == (len(idxs),) + SHAPE + (1,)
    np.testing.assert_allclose(mri.numpy(), np.asarray(want_mri), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(pet.numpy(), np.asarray(want_pet), rtol=0,
                               atol=1e-6)


def test_subject_draws_are_per_index_and_of_the_law():
    noise, flip = quality_torch.subject_draws(3, range(200), (8, 8, 4),
                                              "cpu")
    again, flip_again = quality_torch.subject_draws(3, [5, 7], (8, 8, 4),
                                                    "cpu")
    assert torch.equal(noise[[5, 7]], again)
    assert torch.equal(flip[[5, 7]], flip_again)
    assert abs(float(noise.mean())) < 0.02
    assert abs(float(noise.std()) - 1) < 0.02
    assert 0.08 < float(flip.mean()) < 0.22          # P = 0.15
    _, no_flip = quality_torch.subject_draws(3, range(50), (2, 2, 2), "cpu",
                                             hard=False)
    assert float(no_flip.sum()) == 0


def _finite(obj):
    if isinstance(obj, dict):
        return all(_finite(v) for v in obj.values())
    if isinstance(obj, list):
        return all(_finite(v) for v in obj)
    return not isinstance(obj, float) or math.isfinite(obj)


METRICS = {"precision", "recall", "f1", "accuracy", "mcc"}


def test_small_smoke_writes_a_finite_artifact(tmp_path):
    out = tmp_path / "small.json"
    quality_torch.main(["--geometry", "small", "--smoke", "--device", "cpu",
                        "--out", str(out)])
    report = json.loads(out.read_text())
    assert report["config"]["shape"] == [32, 32, 16]
    assert report["config"]["seeds"] == [0] and report["config"]["smoke"]
    assert set(report["gfe_mamba_torch"]) == METRICS | {"stage1_l1",
                                                        "stage1_psnr"}
    assert len(report["runs"]) == 1
    assert report["reference"]["artifact"] == "QUALITY_r04.json"
    assert report["reference"]["platform"] == "tpu"
    assert set(report["comparison"]) >= {"delta_mcc_pt", "se_delta_mcc_pt",
                                         "delta_f1_pt", "se_delta_f1_pt"}
    assert _finite({k: v for k, v in report.items() if k != "reference"})


def test_canonical_smoke_writes_a_finite_artifact(tmp_path):
    out = tmp_path / "canonical.json"
    quality_torch.main(["--geometry", "canonical", "--smoke", "--tiny",
                        "--device", "cpu", "--out", str(out)])
    report = json.loads(out.read_text())
    config = report["config"]
    assert config["tiny"] and config["shape"] == [32, 32, 16]
    assert (config["n_train"], config["n_val"], config["n_test"]) == (4, 2, 2)
    assert len(report["stage1_l1"]) == len(report["stage2_bce"]) == 1
    assert report["val_mcc"][0][0] == 1 and report["best_val_epoch"] == 1
    assert set(report["final_metrics"]) == METRICS
    assert set(report["best_ckpt_metrics"]) == METRICS
    assert report["reference"]["artifact"] == "CANONICAL_r04.json"
    assert _finite({k: v for k, v in report.items() if k != "reference"})


def test_quality_script_imports_no_jax():
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, "-c", "import sys, quality_torch; "
         "print(sorted(m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'flax', 'gfe_mamba_tpu')))"],
        capture_output=True, text=True, cwd=quality_torch.REPO, check=True,
        timeout=120)
    assert out.stdout.strip() == "[]"


def test_canonical_run_splits_at_the_stage_boundary(tmp_path):
    """``--stage1-npz``: the first run saves its Stage-1 generator, the
    second loads it, skips Stage 1 and replays its batch draws, so its
    Stage 2 is the first run's, step for step; ``--mixed-precision none``
    runs both stages in f32."""
    npz, runs = tmp_path / "g.npz", []
    for i in range(2):
        out = tmp_path / f"run{i}.json"
        quality_torch.main(["--geometry", "canonical", "--smoke", "--tiny",
                            "--device", "cpu", "--out", str(out),
                            "--stage1-npz", str(npz),
                            "--mixed-precision", "none"])
        runs.append(json.loads(out.read_text()))
    assert "stage1_from" not in runs[0] and runs[1]["stage1_from"] == str(npz)
    assert runs[1]["stage1_l1"] == [] and len(runs[0]["stage1_l1"]) == 1
    assert runs[0]["config"]["mixed_precision"] == "none"
    for key in ("stage2_bce", "val_mcc", "final_metrics",
                "best_ckpt_metrics"):
        assert runs[0][key] == runs[1][key], key
