"""The port's public import surface against the JAX package's, and
``ops.scan.linear_recurrence`` against JAX's.

Every name that one of the JAX package's nine ``__init__.py`` files
re-exports resolves on the same subpackage of ``gfe_mamba_torch``, but
three: ``parallel.batch_sharding``, ``shard_batch`` and ``replicated``
place a global array on a JAX mesh, and the port has no SPMD (each rank
keeps its own rows).  The re-exports are lazy: importing a subpackage
loads none of its modules, and resolving every name builds and loads no
kernel library.

``linear_recurrence``: both modes, two axes, within 1e-5 of JAX's
(relative to the largest magnitude), f32 on both sides.
"""

import ast
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfe_mamba_tpu.ops.scan import linear_recurrence as jax_linear_recurrence
from gfe_mamba_torch.ops.scan import linear_recurrence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ["", "models", "ops", "data", "parallel", "segmentation",
               "training", "utils", "losses"]
NO_SPMD = {("parallel", "batch_sharding"), ("parallel", "shard_batch"),
           ("parallel", "replicated")}


def _jax_exports():
    """(subpackage, name) for every name the JAX ``__init__.py`` files
    import."""
    out = []
    for sub in SUBPACKAGES:
        path = os.path.join(REPO, "gfe_mamba_tpu", sub, "__init__.py")
        for node in ast.parse(open(path).read()).body:
            if isinstance(node, ast.ImportFrom):
                out += [(sub, alias.name) for alias in node.names]
    return out


def test_jax_export_counts():
    counts = {}
    for sub, _ in _jax_exports():
        counts[sub] = counts.get(sub, 0) + 1
    assert counts == {"": 1, "models": 35, "ops": 18, "segmentation": 11,
                      "data": 10, "parallel": 7, "utils": 6,
                      "training": 3, "losses": 2}


_RESOLVE = """
import ast, importlib, json, os, sys
exports = json.loads(sys.argv[1])
{prelude}
pkgs = {{s: importlib.import_module("gfe_mamba_torch" + ("." + s if s else ""))
        for s in {subs!r}}}
loaded_on_import = sorted(m for m in sys.modules
                          if m.startswith("gfe_mamba_torch."))
missing = [[s, n] for s, n in exports if not hasattr(pkgs[s], n)]
from gfe_mamba_torch.ops.cuda import build
from gfe_mamba_torch.data import native
print(json.dumps({{"missing": missing, "loaded_on_import": loaded_on_import,
                  "libraries": sorted(build._loaded),
                  "native": native._lib is not None,
                  "modules": sorted(sys.modules)}}))
"""


def _resolve(prelude=""):
    exports = [e for e in _jax_exports() if e not in NO_SPMD]
    script = _RESOLVE.format(prelude=prelude, subs=SUBPACKAGES)
    out = subprocess.run([sys.executable, "-c", script, json.dumps(exports)],
                         capture_output=True, text=True, cwd=REPO,
                         timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_every_jax_export_resolves_but_the_spmd_three():
    got = _resolve()
    assert got["missing"] == []
    # the packages import lazily: nothing but the config module on import
    assert got["loaded_on_import"] == ["gfe_mamba_torch.config"] + sorted(
        f"gfe_mamba_torch.{s}" for s in SUBPACKAGES if s)
    # resolving every name builds and loads no kernel or codec library
    assert got["libraries"] == [] and not got["native"]
    assert not any(m.startswith(("jax", "flax", "gfe_mamba_tpu"))
                   for m in got["modules"])


def test_the_spmd_three_are_the_only_names_left_out():
    import gfe_mamba_torch.parallel as parallel
    for sub, name in NO_SPMD:
        assert not hasattr(parallel, name)
    assert set(_jax_exports()) >= NO_SPMD


@pytest.mark.parametrize("first", ["gfe_mamba_torch.ops.blocks",
                                   "gfe_mamba_torch.models.unet3d"])
def test_no_import_cycle_whatever_is_imported_first(first):
    """``ops.blocks`` imports ``models.dropout``, and ``models.unet3d``
    imports ``ops.blocks``: any first import leaves every name
    resolvable, and ``models`` does not pull in the ViT zoo."""
    got = _resolve(prelude=f"import {first}")
    assert got["missing"] == []
    assert not any("vit_zoo" in m for m in got["modules"])


def test_reexports_are_the_submodules_objects():
    from gfe_mamba_torch import models, ops, parallel, utils
    from gfe_mamba_torch.models import pipeline, vit
    from gfe_mamba_torch.ops import scan
    from gfe_mamba_torch.parallel import multihost
    from gfe_mamba_torch.utils import profiling
    assert models.build_gfe_mamba is pipeline.build_gfe_mamba
    assert models.ViTTransformer is vit.Transformer
    assert ops.linear_recurrence is scan.linear_recurrence
    assert parallel.multihost is multihost
    assert utils.profiling is profiling
    with pytest.raises(AttributeError):
        models.not_a_name
    assert "build_gfe_mamba" in dir(models)


def _recurrence_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    coeffs = rng.uniform(0.5, 1.0, shape).astype(np.float32)
    values = rng.standard_normal(shape).astype(np.float32)
    return coeffs, values


@pytest.mark.parametrize("mode", ["associative", "sequential"])
@pytest.mark.parametrize("axis,shape", [(1, (2, 37, 5)), (0, (19, 3, 4)),
                                        (-1, (3, 4, 33))])
def test_linear_recurrence_equals_jax(mode, axis, shape):
    coeffs, values = _recurrence_inputs(axis + 3, shape)
    want = np.asarray(jax_linear_recurrence(
        jnp.asarray(coeffs), jnp.asarray(values), axis=axis, mode=mode))
    got = linear_recurrence(torch.from_numpy(coeffs),
                            torch.from_numpy(values), axis=axis, mode=mode)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * max(1.0, np.abs(want).max()), err


def test_linear_recurrence_broadcasts_and_refuses_unknown_modes():
    coeffs, values = _recurrence_inputs(0, (2, 9, 4))
    a = coeffs[:, :, :1]                # a coefficient per step, broadcast
    want = np.asarray(jax_linear_recurrence(jnp.asarray(a),
                                            jnp.asarray(values)))
    got = linear_recurrence(torch.from_numpy(a), torch.from_numpy(values))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        jax_linear_recurrence(jnp.asarray(coeffs), jnp.asarray(values),
                              mode="pallas")
    with pytest.raises(ValueError, match="unknown scan mode"):
        linear_recurrence(torch.from_numpy(coeffs), torch.from_numpy(values),
                          mode="pallas")
