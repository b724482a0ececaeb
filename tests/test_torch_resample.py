"""fdc_tpu_torch.utils.resample against fdc_tpu.utils.resample.

``tests/test_resample.py``'s cases, each run through both packages on
the same seeded numpy input: the port's one ``conv1d`` over the
zero-stuffed input against the JAX package's
``lax.conv_general_dilated`` (fp32 sums in other orders: rtol 2e-4 /
atol 2e-5 of the output's max, the stream tolerance), and the same
fidelity checks on the port's output.
"""

import numpy as np
import pytest
import torch

from fdc_tpu.utils import resample as jres
from fdc_tpu_torch.utils import resample as tres

from test_resample import snr_db, tone
from test_torch_slice import ATOL, RTOL, assert_close_to_max


def test_filter_design_is_the_source():
    for args in ((129, 0.25, 8.0), (33, 0.5, 5.0), (17, 0.1, 8.0)):
        np.testing.assert_array_equal(tres.design_kaiser_lowpass(*args),
                                      jres.design_kaiser_lowpass(*args))
    h = tres.design_kaiser_lowpass(129, 0.25)
    assert h.sum() == pytest.approx(1.0, abs=1e-6)
    assert np.argmax(h) == 64
    with pytest.raises(ValueError):
        tres.design_kaiser_lowpass(65, 0.7)


@pytest.mark.parametrize("up,down", [(2, 1), (1, 2), (3, 2), (4, 3), (2, 4)])
def test_tone_through_resampler_matches_jax(up, down):
    f0, n = 0.05, 4096
    x = tone(f0, n)
    y = tres.rational_resample(x, up, down)
    assert y.dtype == torch.complex64
    ref = np.asarray(jres.rational_resample(x, up, down))
    assert y.shape == ref.shape
    assert_close_to_max(y.numpy(), ref, RTOL, ATOL, f"{up}/{down}")
    core = y.numpy()[200:-200]
    assert snr_db(core, f0 * down / up) > 40.0
    assert np.abs(core).mean() == pytest.approx(1.0, abs=0.02)


def test_identity():
    x = tone(0.1, 256)
    np.testing.assert_array_equal(np.asarray(tres.rational_resample(x, 3, 3)),
                                  x)


def test_batched_matches_single_and_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 1024))
         + 1j * rng.standard_normal((3, 1024))).astype(np.complex64)
    yb = tres.rational_resample(torch.from_numpy(x), 3, 4).numpy()
    assert_close_to_max(yb, np.asarray(jres.rational_resample(x, 3, 4)),
                        RTOL, ATOL, "batched")
    for i in range(3):
        yi = tres.rational_resample(x[i], 3, 4).numpy()
        np.testing.assert_allclose(yb[i], yi, rtol=1e-6, atol=1e-6)


def test_common_rate_matches_jax():
    a, b = tone(0.05, 1000), tone(0.02, 2000)
    out = tres.common_rate([a, b], [64, 128], 128)
    ref = jres.common_rate([a, b], [64, 128], 128)
    for o, r in zip(out, ref):
        assert_close_to_max(np.asarray(o), np.asarray(r), RTOL, ATOL,
                            "common_rate")
    assert abs(len(out[0]) - 2000) <= 2
    assert len(out[1]) == 2000
    assert snr_db(out[0].numpy()[200:-200], 0.025) > 40.0
