"""No module under portbench/ imports JAX, Flax or the JAX package,
compared by whole top-level name (the port's name starts with the JAX
package's); the yardstick (reference/, gen/, counts/) imports nothing of
the port either."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "deepmetv2_tpu"}
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("part", ["reference", "gen", "counts"])
def test_yardstick_imports_nothing_of_the_port(part):
    for path in (HERE / part).rglob("*.py"):
        assert "deepmetv2_tpu_torch" not in top_level_imports(path), path


def test_the_check_compares_whole_names():
    from portbench.run import FORBIDDEN as RUN_FORBIDDEN

    assert set(RUN_FORBIDDEN) == FORBIDDEN
    assert "deepmetv2_tpu_torch".split(".")[0] not in FORBIDDEN
