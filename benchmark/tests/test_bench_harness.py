"""The harness: what it loads, how it finds a cell's files by name, how
it reduces a trace, and how it refuses a machine without a card."""

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from benchmark import harness, trace as tr

ROOT = Path(__file__).resolve().parents[2]
RUN = [sys.executable, "benchmark/run.py"]


def top_level_modules(code):
    """Top-level names of the modules a fresh interpreter holds after
    ``code``."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split("
         "'.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_reference_and_traffic_load_neither_jax_nor_the_program():
    mods = top_level_modules(
        "import benchmark.reference.compare, benchmark.reference.control, "
        "benchmark.traffic.generator")
    assert not mods & {"jax", "jaxlib", "flax", "fdc_tpu", "fdc_tpu_torch"}


def test_harness_and_program_load_no_jax():
    mods = top_level_modules(
        "from benchmark import harness\n"
        "harness.make_program(harness.cell_of(harness.bench_file(), "
        "'flagship.mixed')[1]['channelizer'], 'cpu')")
    assert "fdc_tpu_torch" in mods
    assert not mods & harness.FOREIGN


def test_foreign_modules_compare_whole_names():
    assert harness.foreign_modules(
        ["fdc_tpu_torch", "fdc_tpu_torch.ops", "jaxtyping", "numpy"]) == []
    assert harness.foreign_modules(
        ["fdc_tpu.models", "jax._src", "flax"]) == ["fdc_tpu", "flax", "jax"]


def test_no_card_no_result():
    if _has_card():
        pytest.skip("a CUDA device is present")
    p = subprocess.run(RUN + ["--workload", "flagship.mixed", "--seed", "1",
                              "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""


def test_bare_directory_no_result(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files alone."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(RUN + ["--workload", "flagship.mixed", "--seed", "1",
                              "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, env=env)
    assert p.returncode != 0 and p.stdout == ""


def _has_card():
    import torch

    return torch.cuda.is_available()


def test_throwaway_entries_need_no_harness_edit(tmp_path):
    """A configuration, a mix and a per-layer metric added as files and
    entries alone run through the harness unchanged."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((ROOT / "benchmark/configs/flagship.json").read_text())
    conf["channelizer"]["throughput_channels"] = (
        conf["channelizer"]["throughput_channels"][:8])
    (tmp_path / "benchmark/configs/throwaway.json").write_text(
        json.dumps(conf))
    mix = json.loads((ROOT / "benchmark/traffic/mixed.json").read_text())
    mix.update(ring_batches=2, static_tone=0.5)
    mix["burst_channels"].update(on_blocks=[40, 60], off_blocks=[40, 60])
    for lane in mix["segments"]["lanes"]:
        lane.update(on_blocks=[24, 48], off_blocks=[24, 48])
    (tmp_path / "benchmark/traffic/throwmix.json").write_text(
        json.dumps(mix))
    (tmp_path / "benchmark/metrics/calls_per_s.py").write_text(
        textwrap.dedent('''
        def read(ctx):
            return len(ctx.latencies) / ctx.window_s
        '''))
    bench["configs"].append(dict(bench["configs"][0], name="throwaway",
                                 file="benchmark/configs/throwaway.json"))
    bench["workloads"].append(dict(bench["workloads"][0],
                                   name="throwaway.throwmix",
                                   config="throwaway", traffic="throwmix"))
    bench["end_to_end"].append({"name": "calls_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["throwaway.throwmix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent('''
        import json, sys, time
        sys.path.insert(0, ".")
        from benchmark import harness
        r = harness.run_cell("throwaway.throwmix", 5, 2.0, False,
                             time.perf_counter(), device="cpu",
                             cfg_over={"batch_blocks": 48})
        print(json.dumps(r))
        ''')
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"], r["compared"]
    assert set(r["metrics"]) == {"stream_msps", "setup_s", "calls_per_s"}


def synthetic_trace(path, calls=2):
    """A Chrome trace of ``calls`` process() spans of 1000 us, each with a
    copy-out span, a 100 us kernel F, two 50 us GEMMs and a 20 us copy."""
    ev = []
    for c in range(calls):
        t = 1000.0 * c
        ev += [
            {"ph": "X", "cat": "user_annotation", "name": "bench.process",
             "ts": t, "dur": 1000.0},
            {"ph": "X", "cat": "user_annotation", "name": "bench.to_host",
             "ts": t + 500, "dur": 400.0},
            {"ph": "X", "cat": "kernel", "name": "void radix_fft<4096>()",
             "ts": t + 10, "dur": 100.0},
            {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_f32f32",
             "ts": t + 200, "dur": 50.0},
            {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_f32f32",
             "ts": t + 260, "dur": 50.0},
            {"ph": "X", "cat": "kernel", "name": "void gather_gemm<1>()",
             "ts": t + 150, "dur": 40.0},
            {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
             "ts": t + 500, "dur": 20.0},
        ]
    Path(path).write_text(json.dumps({"traceEvents": ev}))


def test_trace_reduction(tmp_path):
    from benchmark.metrics import (device_idle_pct, fft_roofline_pct,
                                   slot_roofline_pct, step_busy_ms)

    synthetic_trace(tmp_path / "t.json")
    t = tr.read_trace(str(tmp_path / "t.json"), 2)
    assert t.seconds == pytest.approx(2e-3)
    # kernels 10-110, 150-190, 200-250, 260-310 us a call: 240 us
    assert tr.busy_seconds(t, ("kernel",)) == pytest.approx(480e-6)
    assert tr.busy_seconds(t) == pytest.approx(520e-6)
    cfg = json.loads((ROOT / "benchmark/configs/hunter4seg.json")
                     .read_text())["channelizer"]
    ctx = harness.Context(cfg=cfg, device_kind="NVIDIA H100 80GB HBM3",
                          trace=t)
    assert step_busy_ms.read(ctx) == pytest.approx(0.24)
    assert device_idle_pct.read(ctx) == pytest.approx(74.0)
    bound = fft_roofline_pct.bound_s(512, 4096, {"fp32_per_s": 67e12,
                                                 "bytes_per_s": 3.35e12})
    assert fft_roofline_pct.read(ctx) == pytest.approx(100 * bound / 1e-4)
    # hunter4seg: 8 slot products a step, 2 GEMM kernels a call here
    assert slot_roofline_pct.read(ctx) is None
    bd = tr.breakdown(t)
    assert bd["device_ops"][0][0].startswith("void radix_fft")
    names = dict(bd["idle_gaps"])
    # idle time by the innermost span: 520-900 us of each call in the
    # copy-out span, the rest in process()
    assert set(names) == {"bench.to_host", "bench.process"}
    assert sum(names.values()) == pytest.approx(2e-3 - 520e-6)
    assert names["bench.to_host"] == pytest.approx(2 * 380e-6)


def test_process_p95_leaves_out_profiled_calls():
    from benchmark.metrics import batch_p95_ms, process_p95_ms

    ctx = harness.Context(cfg={}, latencies=[0.01] * 95 + [0.02] * 5,
                          first_call=27)
    assert process_p95_ms.read(ctx) is None  # an untraced run
    assert batch_p95_ms.read(ctx) == pytest.approx(10.5)
    ctx.spans = tr.Spans()
    # the five slow calls are the profiled ones
    ctx.spans.skip = set(range(27 + 95, 27 + 100))
    assert process_p95_ms.read(ctx) == pytest.approx(10.0)
    ctx.spans.skip = set()
    assert process_p95_ms.read(ctx) == pytest.approx(10.5)


def test_trace_without_process_spans_fails(tmp_path):
    synthetic_trace(tmp_path / "t.json")
    with pytest.raises(RuntimeError):
        tr.read_trace(str(tmp_path / "t.json"), 3)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["flagship.mixed", "hunter4seg.bursty"])
def test_cell_on_the_card(card, workload):
    """A short traced run of each cell on the card: correct, every
    per-layer metric read, no roofline above 100%."""
    p = subprocess.run(RUN + ["--workload", workload, "--seed", "4242",
                              "--seconds", "4", "--trace", "1"],
                       cwd=ROOT, capture_output=True, text=True)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"], r["compared"]
    for name in ("fft_roofline_pct", "slot_roofline_pct"):
        assert 0 < r["metrics"][name]["value"] <= 100
