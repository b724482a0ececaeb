"""The port's export surface covers fdc_tpu's.

Every ``__all__`` of ``fdc_tpu``, ``fdc_tpu.models``, ``fdc_tpu.ops``,
``fdc_tpu.utils`` and ``fdc_tpu.parallel`` is in the port's counterpart,
apart from ``comb_subband_ifft`` (not ported: the gather form that
``interp_subband_ifft`` superseded), and every name resolves to an
object of the port. ``import fdc_tpu_torch`` loads no module of
``parallel/`` (its names are imported on first use) and never JAX.
"""

import importlib
import subprocess
import sys

import pytest

NOT_PORTED = {"comb_subband_ifft"}
PACKAGES = ["", ".models", ".ops", ".utils", ".parallel"]


@pytest.mark.parametrize("sub", PACKAGES)
def test_all_covers_fdc_tpus(sub):
    src = importlib.import_module(f"fdc_tpu{sub}")
    port = importlib.import_module(f"fdc_tpu_torch{sub}")
    missing = set(src.__all__) - set(port.__all__) - NOT_PORTED
    assert not missing, missing
    for name in port.__all__:
        obj = getattr(port, name)
        mod = getattr(obj, "__module__", None) or port.__name__
        assert mod.startswith("fdc_tpu_torch"), (name, mod)


@pytest.mark.parametrize("sub", PACKAGES)
def test_unknown_names_raise(sub):
    port = importlib.import_module(f"fdc_tpu_torch{sub}")
    with pytest.raises(AttributeError):
        getattr(port, "no_such_name")


def test_import_loads_no_parallel_module():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['fdc_tpu'] = None\n"
        "import fdc_tpu_torch\n"
        "bad = [m for m in sys.modules\n"
        "       if m.startswith('fdc_tpu_torch.parallel')]\n"
        "assert not bad, bad\n"
        "assert fdc_tpu_torch.nextpow2(1000) == 1024\n"
        "assert fdc_tpu_torch.is_pow2(4096)\n"
        "assert fdc_tpu_torch.FreqMode.normalized == 0\n"
        "cls = fdc_tpu_torch.ShardedChannelizer\n"
        "assert 'fdc_tpu_torch.parallel.sharded' in sys.modules\n"
        "assert fdc_tpu_torch.make_mesh.__module__ == "
        "'fdc_tpu_torch.parallel.mesh'\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
