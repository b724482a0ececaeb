"""The port's copies of the JAX package's host modules stay copies.

``fdc_tpu_torch`` may not import ``fdc_tpu`` (every ``fdc_tpu`` import
loads JAX), so the host modules that need no JAX are copied:
``config.py``, ``ops/windows.py``, ``utils/events.py``,
``utils/logging.py`` whole, and the Python emitters of
``runtime/emission.py`` without the native ones. Each copy must equal
its source apart from its first line (the provenance note) and the
``fdc_tpu`` -> ``fdc_tpu_torch`` import lines; a fix made in one package
and not the other fails here.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def import_line(line):
    return line.lstrip().startswith(("from fdc_tpu", "import fdc_tpu"))


def as_source(line):
    """A port line as it reads in the JAX package: import lines name
    fdc_tpu, every other line is left as it is."""
    return line.replace("fdc_tpu_torch", "fdc_tpu") if import_line(
        line) else line


@pytest.mark.parametrize("rel", ["config.py", "ops/windows.py",
                                 "utils/events.py", "utils/logging.py"])
def test_whole_copy_equals_its_source(rel):
    port = (ROOT / "fdc_tpu_torch" / rel).read_text().splitlines()
    src = (ROOT / "fdc_tpu" / rel).read_text().splitlines()
    assert port[0].startswith(f"# Copied from fdc_tpu/{rel}")
    assert [as_source(line) for line in port[1:]] == src


def top_level(path):
    """{name: source} of a module's top-level definitions and
    assignments, and {module: names} of its imports (fdc_tpu_torch read
    as fdc_tpu)."""
    text = path.read_text()
    tree = ast.parse(text)
    defs, imports = {}, {}
    for node in tree.body:
        seg = ast.get_source_segment(text, node)
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mod = as_source(f"from {getattr(node, 'module', '')}")
            imports.setdefault(mod, set()).update(
                (a.name, a.asname) for a in node.names)
        elif isinstance(node, ast.Assign):
            defs[",".join(ast.unparse(t) for t in node.targets)] = seg
        elif hasattr(node, "name"):
            defs[node.name] = seg
    return ast.get_docstring(tree), defs, imports


def test_python_emitters_equal_their_source():
    rel = "runtime/emission.py"
    doc, defs, imports = top_level(ROOT / "fdc_tpu_torch" / rel)
    src_doc, src_defs, src_imports = top_level(ROOT / "fdc_tpu" / rel)
    first = (ROOT / "fdc_tpu_torch" / rel).read_text().splitlines()[0]
    assert first.startswith(f"# Copied from fdc_tpu/{rel}")
    assert doc == src_doc
    # the port's imports, in the JAX package's names, are among the
    # source's (the native emitters' own are left out)
    for mod, names in imports.items():
        assert names <= src_imports.get(mod, set()), mod
    all_names = ast.literal_eval(defs.pop("__all__").split("=", 1)[1])
    src_all = ast.literal_eval(src_defs["__all__"].split("=", 1)[1])
    assert set(all_names) <= set(src_all)
    assert {"PowerActivationEmitter", "SegmentDetectionEmitter"} <= set(defs)
    for name, seg in defs.items():
        assert seg == src_defs.get(name), name
