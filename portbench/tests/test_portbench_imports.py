"""Nothing under the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program. Names are compared by their whole
top-level part: the program's name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "levelsetfusion_tpu"}
PROGRAM = "levelsetfusion_tpu_torch"
FILES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    found = set(top_level_imports(path)) & FORBIDDEN
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = set(top_level_imports(path))
    assert PROGRAM not in names and not names & FORBIDDEN, names
    assert names <= {"__future__", "math", "typing", "numpy", "torch", "portbench"}


def test_the_guard_compares_whole_names(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import levelsetfusion_tpu_torch.ops\nfrom jaxtyping import Array\n")
    assert not set(top_level_imports(f)) & FORBIDDEN
    f.write_text("from levelsetfusion_tpu.ops import tsdf\n")
    assert set(top_level_imports(f)) & FORBIDDEN == {"levelsetfusion_tpu"}
