"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "soundswallower_tpu"}


def sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not set(top_names(path)) & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(HERE, "reference")
    for d, _, files in os.walk(ref):
        for f in files:
            if f.endswith(".py"):
                names = set(top_names(os.path.join(d, f)))
                assert "soundswallower_tpu_torch" not in names, f
                assert "portbench" not in names, f


def test_top_level_names_compared_whole():
    from portbench.run import forbidden_modules
    import sys
    import types

    sys.modules["soundswallower_tpu_torch_fake"] = types.ModuleType("x")
    try:
        assert forbidden_modules() == []
        sys.modules["soundswallower_tpu"] = types.ModuleType("y")
        assert forbidden_modules() == ["soundswallower_tpu"]
    finally:
        sys.modules.pop("soundswallower_tpu_torch_fake", None)
        sys.modules.pop("soundswallower_tpu", None)
