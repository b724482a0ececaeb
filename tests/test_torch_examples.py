"""The port's examples against fdc_tpu's, on the CPU.

``examples/fdc_example_torch.py`` and ``examples/pod_burst_hunter_torch.py``
run in this process through ``main([..., "--cpu"])`` (the kernels' plain
versions; the pod hunter's ranks and pipeline lanes are CPU ranks);
``fdc_tpu``'s ``examples/fdc_example.py`` and
``examples/pod_burst_hunter.py`` run with the same arguments in a process
of their own, because the pod hunter sets JAX's platform and CPU device
count, which a JAX already started here refuses. Both print the same
lines, the timestamped prefix of each event ID aside: blocks processed,
event counts, each listed event's blocks, cfreq, bw and length (exact,
as printed), and the throughput streams' lengths and mean magnitudes
(the means within their printed rounding).
"""

import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = {
    "fdc_example": ["--blocks", "64"],
    "pod_burst_hunter": ["--devices", "4", "--n-chan", "2", "--batches",
                         "3"],
}
# an event line: "  <timestamp>.<SRC.UNIT.COUNTER>  <fields>"
EVENT = re.compile(r"^  \S+?\.(\S+)  (.*)$")
MEAN = re.compile(r"^(throughput ch\d+: \d+ samples, mean \|x\| = )(\S+)$")


def port_main(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def lines(text):
    """The printed lines, event IDs without their timestamps; the progress
    and PNG lines left out."""
    out = []
    for ln in text.splitlines():
        if ln.startswith(("synthesizing", "processing", "waterfall")):
            continue
        m = EVENT.match(ln)
        out.append(f"  {m.group(1)}  {m.group(2)}" if m else ln)
    return out


def assert_same_lines(got, ref):
    assert len(got) == len(ref), (got, ref)
    for a, b in zip(got, ref):
        ma, mb = MEAN.match(a), MEAN.match(b)
        if ma and mb:
            assert ma.group(1) == mb.group(1)
            assert abs(float(ma.group(2)) - float(mb.group(2))) <= 1.5e-3
        else:
            assert a == b


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_port_example_prints_fdc_tpus_lines(name, tmp_path):
    args = EXAMPLES[name] + ["--out", str(tmp_path / "waterfall.png")]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert port_main(name)(args + ["--cpu"]) == 0
    extra = ["--cpu"] if name == "fdc_example" else []
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"{name}.py"), *args,
         *extra], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    assert ref.returncode == 0, ref.stderr[-4000:]
    got, want = lines(buf.getvalue()), lines(ref.stdout)
    assert any("blocks=[" in ln for ln in want)
    assert_same_lines(got, want)


def test_port_examples_import_no_jax():
    """The examples of the port import fdc_tpu_torch, never jax or
    fdc_tpu (tests/test_torch_copies.py guards their imports too)."""
    for name in EXAMPLES:
        text = (ROOT / "examples" / f"{name}_torch.py").read_text()
        assert "fdc_tpu_torch" in text
        assert not re.search(r"^\s*(import|from)\s+(jax|fdc_tpu)\b", text,
                             re.M)
