"""What the benchmark loads: never JAX or the JAX package (compared by
whole top-level names), and the reference nothing of the program."""

import ast
import subprocess
import sys

from portbench.core.bench import FORBIDDEN
from portbench.core.registry import PACKAGE, ROOT

LOAD_ALL = """
import sys
sys.path.insert(0, {root!r})
import portbench.core.bench, portbench.control
from portbench.core.registry import Cell
import json
bench = json.load(open({root!r} + "/BENCHMARK.json"))
for w in bench["workloads"]:
    c = Cell(w["name"])
    c.driver()
    for m in bench["per_layer"]:
        c.reader(m["name"])
import gfe_mamba_torch.models.pipeline, gfe_mamba_torch.segmentation.trainer
import gfe_mamba_torch.training.classify_trainer
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_nothing_loads_jax():
    out = subprocess.run([sys.executable, "-c",
                          LOAD_ALL.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    loaded = set(eval(out.strip().splitlines()[-1]))
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)
    assert "gfe_mamba_torch" in loaded


def imported_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_reference_imports_nothing_of_the_program():
    files = sorted((PACKAGE / "reference").glob("*.py"))
    assert files
    for f in files:
        for name in imported_names(f):
            top = name.split(".")[0]
            assert top not in ("gfe_mamba_torch",) + FORBIDDEN, (f, name)
            assert top in ("torch", "math", "__future__", "portbench"), \
                (f, name)
            if top == "portbench":
                assert name.startswith("portbench.reference"), (f, name)


def test_reference_loads_without_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.gfe_mamba, portbench.reference.unet,"
            " portbench.reference.train, portbench.reference.precision; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    loaded = set(eval(out.strip().splitlines()[-1]))
    assert "gfe_mamba_torch" not in loaded
    assert not loaded & set(FORBIDDEN)
