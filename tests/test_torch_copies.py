"""The port's copies of the JAX package's host modules stay copies.

``fdc_tpu_torch`` may not import ``fdc_tpu`` (every ``fdc_tpu`` import
loads JAX), so the host modules that need no JAX are copied:
``config.py``, ``ops/windows.py``, ``utils/events.py``,
``utils/logging.py``, ``runtime/emission.py``, ``runtime/stream.py`` and
``utils/waterfall.py`` whole, ``utils/resample.py``'s filter design
(``design_kaiser_lowpass``), the native runtime's C++ sources
(``runtime/native/ring.cc``, ``emission.cc``) verbatim, and its loader
(``runtime/native/__init__.py``) apart from the lines that build the
library, and the cross-process pipeline's codec, framing and worker
connection (``parallel/hostpipe.py``, definition by definition). Each
Python copy must equal its source apart from its first line (the
provenance note) and the ``fdc_tpu`` -> ``fdc_tpu_torch`` import lines;
a fix made in one package and not the other fails here.
The last test holds the rule behind the copies: no module of the port,
its command line, ``chip_smoke.py``, ``tools_torch/`` or the port's
examples (``examples/*_torch.py``) imports ``jax`` or ``fdc_tpu``.
"""

import ast
import difflib
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
                                 "utils/events.py", "utils/logging.py",
                                 "runtime/emission.py", "runtime/stream.py",
                                 "utils/waterfall.py"])
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
    assert all_names == src_all
    assert {"PowerActivationEmitter", "SegmentDetectionEmitter",
            "NativePowerActivationEmitter",
            "NativeSegmentDetectionEmitter"} <= set(defs)
    for name, seg in defs.items():
        # an import inside a function (the native emitters' loader) reads
        # as the source's too
        seg = "\n".join(as_source(line) for line in seg.splitlines())
        assert seg == src_defs.get(name), name


HOSTPIPE_COPIES = ("_MAGIC", "_VERSION", "_enc_tree", "_dec_tree",
                   "_send_msg", "_recv_exact", "_recv_msg", "_WorkerConn")


@pytest.mark.parametrize("name", HOSTPIPE_COPIES)
def test_hostpipe_wire_definitions_equal_their_source(name):
    """The message codec, its framing and the owner's worker connection
    are fdc_tpu's, definition by definition (the owners and workers are
    the port's own: they drive its pipeline)."""
    rel = "parallel/hostpipe.py"
    port_path = ROOT / "fdc_tpu_torch" / rel
    assert port_path.read_text().startswith(f"# Copied from fdc_tpu/{rel}")
    _, defs, imports = top_level(port_path)
    _, src_defs, src_imports = top_level(ROOT / "fdc_tpu" / rel)
    assert defs[name] == src_defs[name]
    # the modules the copied definitions use are imported as the source
    # imports them (``import x`` statements file under "from ")
    plain = {(m, a) for m, a in src_imports["from "]
             if m.split(".")[0] != "jax"}
    assert plain <= imports["from "]
    assert imports["from queue"] == src_imports["from queue"]


def test_kaiser_lowpass_equals_its_source():
    """``design_kaiser_lowpass`` (numpy) is fdc_tpu's, definition for
    definition; the resampler around it is the port's own (conv1d)."""
    rel = "utils/resample.py"
    _, defs, _ = top_level(ROOT / "fdc_tpu_torch" / rel)
    _, src_defs, _ = top_level(ROOT / "fdc_tpu" / rel)
    assert defs["design_kaiser_lowpass"] == src_defs["design_kaiser_lowpass"]
    assert defs["__all__"] == src_defs["__all__"]


@pytest.mark.parametrize("name", ["ring.cc", "emission.cc"])
def test_native_sources_are_verbatim(name):
    rel = f"runtime/native/{name}"
    port = (ROOT / "fdc_tpu_torch" / rel).read_text().splitlines()
    src = (ROOT / "fdc_tpu" / rel).read_text().splitlines()
    assert port[0].startswith(f"// Copied from fdc_tpu/{rel}")
    assert port[1:] == src


def test_native_loader_differs_only_in_its_build_lines():
    """The loader's ctypes bindings and classes are the source's; only the
    build differs (into fdc_tpu_torch/_build/, keyed by a hash of the
    sources, through a temporary name)."""
    rel = "runtime/native/__init__.py"
    port_path, src_path = ROOT / "fdc_tpu_torch" / rel, ROOT / "fdc_tpu" / rel
    assert port_path.read_text().startswith(f"# Copied from fdc_tpu/{rel}")
    doc, defs, imports = top_level(port_path)
    src_doc, src_defs, src_imports = top_level(src_path)
    assert doc == src_doc
    assert imports == {**src_imports, "from ": src_imports["from "] | {
        ("hashlib", None)}}
    build = {"_LIB", "_BUILD", "_FLAGS", "_build", "_load"}
    assert set(defs) - build == set(src_defs) - build
    for name in set(defs) - build:
        assert defs[name] == src_defs[name], name
    assert {"_BUILD", "_FLAGS", "_build"} <= set(defs)
    diff = [line for line in difflib.ndiff(src_defs["_load"].splitlines(),
                                           defs["_load"].splitlines())
            if line[:1] in "+-"]
    # _load only takes the built library's path from _build()
    assert [line for line in diff if line[0] == "+"] == [
        "+             lib = ctypes.CDLL(_build())"]
    assert all("_LIB" in line or "_build()" in line or "src_mtime" in line
               for line in diff if line[0] == "-")


def imported_modules(path):
    """Every module a file imports, at any depth (relative imports are
    the port's own)."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module


def test_port_imports_neither_jax_nor_fdc_tpu():
    files = sorted((ROOT / "fdc_tpu_torch").rglob("*.py"))
    assert ROOT / "fdc_tpu_torch" / "__main__.py" in files
    assert {ROOT / "fdc_tpu_torch" / "parallel" / f for f in (
        "__init__.py", "pipeline.py", "hostpipe.py", "lanes.py", "mesh.py",
        "sharded.py", "multihost.py")} <= set(files)
    files.append(ROOT / "chip_smoke.py")
    files += sorted((ROOT / "tools_torch").glob("*.py"))
    assert ROOT / "tools_torch" / "multihost_worker.py" in files
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    assert {e.name for e in examples} >= {"fdc_example_torch.py",
                                          "pod_burst_hunter_torch.py"}
    files += examples
    bad = [(str(f.relative_to(ROOT)), m)
           for f in files for m in imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "fdc_tpu")]
    assert not bad
