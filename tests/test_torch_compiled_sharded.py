"""The sharded step compiled against fdc_tpu's jitted shard_map step.

``ShardedChannelizer`` captures its whole step over the ranks' streams
(``_jit_step``, ``_jit_step_spectra``), as ``fdc_tpu`` jits its shard_map
step. On the CPU a compiled call runs the step eagerly through the same
static inputs, carry copy-back and reused output buffers, its first call
per shape under the capture guard. The runs on CPU meshes of ranks are
held against ``fdc_tpu``'s sharded channelizer on the forced CPU mesh,
on the same inputs made with numpy from a seed, and against the eager
opt-out (``compile_step`` on the instance), bit for bit. Tolerances as
``tests/test_torch_compiled_lanes.py``'s.
"""

import numpy as np
import pytest

from fdc_tpu.models.channelizer import FrequencyDomainChannelizer as JaxFDC
from fdc_tpu.runtime import checkpoint as jax_ckpt
from fdc_tpu_torch import FrequencyDomainChannelizer
from fdc_tpu_torch.runtime import checkpoint as ckpt

from golden import golden_forward_fft, golden_overlap_save
from test_torch_compiled import (
    assert_results_close,
    assert_results_equal,
    eager,
    run,
)
from test_torch_compiled_lanes import _joined, case, jax_sharded, sharded


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
@pytest.mark.parametrize("name", ["flagship", "split"])
def test_compiled_sharded_matches_jax(name, mesh):
    """process() + flush() through the compiled sharded step: the stream's
    carry is its static carry, one graph a batch shape; fdc_tpu's sharded
    run's results, and the eager opt-out's bit for bit (at 2x2 the split
    parts' scans run in chan owner groups, their cut views across the
    ranks' streams)."""
    jcfg, pcfg, x = case(name)
    sh = sharded(pcfg, *mesh)
    got = run(sh, x)
    assert sh.compile_step and sh._jit_step.owns(sh._carry)
    assert len(sh._jit_step._entries) == 1
    if name == "split" and mesh == (2, 2):
        assert [o for o, _ in sh._owner_groups] == [0, 1]
    assert_results_close(got, run(jax_sharded(jcfg, *mesh), x))
    assert_results_equal(got, run(eager(sharded(pcfg, *mesh)), x))


def test_compiled_sharded_process_spectra_matches_jax():
    """process_spectra on ragged row counts, then flush, through the
    compiled spectra step on a 2x2 mesh, against fdc_tpu's sharded vector
    mode."""
    jcfg, pcfg, x = case("flagship")
    blocks, _ = golden_overlap_save(x.astype(np.complex128), 1024,
                                    pcfg.ovllen)
    spectra = golden_forward_fft(blocks).astype(np.complex64)[:35]
    cuts = [0, 5, 16, 19, 35]
    models = (sharded(pcfg, 2, 2), jax_sharded(jcfg, 2, 2))
    results = []
    for m in models:
        results.append([m.process_spectra(spectra[a:b])
                        for a, b in zip(cuts, cuts[1:])] + [m.flush()])
    assert models[0]._jit_step_spectra.owns(models[0]._carry)
    assert not models[0]._jit_step._entries
    assert_results_close(*results)


def test_compiled_sharded_checkpoint_resumes_in_plain(tmp_path):
    """The compiled sharded stream saved mid-batch inside a burst; a plain
    channelizer of each package resumes the file: the joined run equals
    fdc_tpu's uninterrupted one."""
    jcfg, pcfg, x = case("flagship")
    cut = 2 * pcfg.batch_blocks * pcfg.inplen + 777
    sh = sharded(pcfg, 2, 2)
    head = sh.process(x[:cut])
    assert sh._jit_step.owns(sh._carry)
    ckpt.save_checkpoint(sh, str(tmp_path / "sh.ckpt"))
    ref = run(JaxFDC(jcfg), x)
    port = FrequencyDomainChannelizer(pcfg, device="cpu")
    ckpt.load_checkpoint(port, str(tmp_path / "sh.ckpt"))
    got = [head, port.process(x[cut:]), port.flush()]
    assert_results_close([_joined(got)], [_joined(ref)])
    jf = JaxFDC(jcfg)
    jax_ckpt.load_checkpoint(jf, str(tmp_path / "sh.ckpt"))
    assert_results_close(
        [_joined(got)], [_joined([head, jf.process(x[cut:]), jf.flush()])])


