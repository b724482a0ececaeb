"""``python -m fdc_tpu_torch`` against ``python -m fdc_tpu``.

Both CLIs run in-process through ``main([...])`` (as tests/test_cli.py
drives the JAX one), the port with ``--cpu`` (the kernels' plain
versions), on the same config and capture. Held to ROADMAP's tolerances:
the events JSONL exact apart from the timestamped ID prefix, the event
payload files by name (without the prefix) and the throughput streams
within rtol 2e-4 / atol 2e-5 of the max (the two packages' FFTs round
differently). The checkpoint split cuts inside a burst, mid-batch, and
crosses packages both ways. The multi-device flags (``--pipeline``,
``--dedicated-owner``, ``--pipeline-scan-owners``, ``--cpu-devices``,
``--hostpipe-*``, and the SPMD ``--time-shards``, ``--chan-shards`` and
``--pipeline-shard-time`` on an 8-device CPU mesh) run, each against
``fdc_tpu``'s ``main()`` on the same argv.
"""

import json
import socket
import threading
import time

import numpy as np
import pytest

from fdc_tpu.__main__ import main as jax_main
from fdc_tpu_torch.__main__ import main

from test_torch_slice import ATOL, RTOL, assert_close_to_max

INPLEN = 768
N_BLOCKS = 48
# mid-batch (batch 16), inside the burst (blocks 12-24)
SPLIT = 16 * INPLEN + 777


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The config (tests/test_cli.py's; also with its segment split in 3)
    and a ragged capture: a tone in the throughput channel, a burst in the
    burst channel and a carrier in the detection segment (normalized
    0.35, inside (0.30, 0.42)), then the capture's two halves at
    SPLIT."""
    from fdc_tpu_torch.config import ChannelizerConfig

    d = tmp_path_factory.mktemp("cli")
    cfg = ChannelizerConfig(
        blocksize=1024, relinvovl=4,
        throughput_channels=((0.12, 0.05),),
        activity_controlled_channels=((0.22, 0.1),),
        activity_detection_segments=((0.30, 0.42),),
        batch_blocks=16, max_slots=8,
    )
    (d / "cfg.json").write_text(cfg.to_json())
    (d / "split.json").write_text(
        cfg.replace(segment_splits=((0, 3, 2),)).to_json())
    rng = np.random.default_rng(7)
    n = N_BLOCKS * INPLEN
    t = np.arange(n)
    burst = np.zeros(n)
    burst[n // 4: n // 2] = 1.0
    x = (0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         + 0.9 * np.exp(2j * np.pi * 0.12 * t)
         + burst * (0.8 * np.exp(2j * np.pi * 0.22 * t)
                    + 0.9 * np.exp(2j * np.pi * 0.35 * t)))
    x = x[:-1000].astype(np.complex64)  # ragged: 46.7 blocks
    x.tofile(d / "cap.c64")
    x[:SPLIT].tofile(d / "a.c64")
    x[SPLIT:].tofile(d / "b.c64")
    return d


def cli(fn, cmd, d, out, capture="cap.c64", extra=()):
    """One CLI run into ``d/out`` (event files, streams, events.jsonl)."""
    argv = [cmd, str(d / "cfg.json"), str(d / capture),
            "--out-dir", str(d / out), "--events-jsonl",
            str(d / f"{out}.jsonl"), *extra]
    assert fn(argv) == 0
    return d / out


def port(cmd, d, out, capture="cap.c64", extra=()):
    return cli(main, cmd, d, out, capture, ("--cpu", *extra))


def jax(cmd, d, out, capture="cap.c64", extra=()):
    return cli(jax_main, cmd, d, out, capture, ("--cpu", *extra))


def outputs(*dirs):
    """The joined outputs of runs: (events without the ID prefix,
    {stream file: samples}, {payload file without the prefix: samples})."""
    events, streams, payloads = [], {}, {}
    for out in dirs:
        for line in out.with_suffix(".jsonl").read_text().splitlines():
            ev = json.loads(line)
            ev["ID"] = ev["ID"].split(".", 1)[1]
            events.append(ev)
        for f in sorted(out.iterdir()):
            x = np.fromfile(f, np.complex64)
            if f.name.startswith("throughput_ch"):
                streams[f.name] = np.concatenate(
                    [streams.get(f.name, np.zeros(0, np.complex64)), x])
            else:
                payloads[f.name.split(".", 1)[1]] = x
    return events, streams, payloads


def assert_same_outputs(got, ref):
    ev, streams, payloads = got
    ev_ref, streams_ref, payloads_ref = ref
    assert ev == ev_ref
    assert {e["ID"].split(".")[0] for e in ev} == {"PowActChan", "DETECTED"}
    assert streams.keys() == streams_ref.keys() and streams
    for name in streams:
        assert streams[name].shape == streams_ref[name].shape
        assert_close_to_max(streams[name], streams_ref[name], RTOL, ATOL,
                            name)
    assert sorted(payloads) == sorted(payloads_ref) and payloads
    assert_close_to_max(
        np.concatenate([payloads[k] for k in sorted(payloads)]),
        np.concatenate([payloads_ref[k] for k in sorted(payloads)]),
        RTOL, ATOL, "event files")


@pytest.fixture(scope="module")
def jax_run(files):
    return outputs(jax("run", files, "jax_run"))


@pytest.fixture(scope="module")
def jax_vcm(files):
    return outputs(jax("vcm", files, "jax_vcm"))


def test_template_and_config_print_fdc_tpus(files, capsys):
    for argv in (["template"], ["config", str(files / "cfg.json")]):
        assert jax_main(argv) == 0
        ref = capsys.readouterr().out
        assert main(argv) == 0
        assert capsys.readouterr().out == ref
    split = files / "split.json"
    assert jax_main(["config", str(split)]) == 0
    ref = capsys.readouterr().out
    assert "part[2]" in ref
    assert main(["config", str(split)]) == 0
    assert capsys.readouterr().out == ref


def test_run_matches_fdc_tpu(files, jax_run, capsys):
    out = port("run", files, "port_run")
    log = capsys.readouterr().out
    assert f"samples in:       {N_BLOCKS * INPLEN - 1000}" in log
    assert "blocks processed: 47" in log  # the ragged tail was flushed
    assert_same_outputs(outputs(out), jax_run)


def test_run_no_native_matches(files, jax_run):
    assert_same_outputs(outputs(port("run", files, "port_py",
                                     extra=("--no-native",))), jax_run)


def test_vcm_matches_fdc_tpu(files, jax_vcm):
    ev, _, payloads = outputs(port("vcm", files, "port_vcm"))
    ev_ref, _, payloads_ref = jax_vcm
    assert ev == ev_ref and len(ev) >= 2
    assert sorted(payloads) == sorted(payloads_ref)
    assert_close_to_max(
        np.concatenate([payloads[k] for k in sorted(payloads)]),
        np.concatenate([payloads_ref[k] for k in sorted(payloads)]),
        RTOL, ATOL, "vcm event files")


@pytest.mark.parametrize("direction", ["port-to-port", "jax-to-port",
                                       "port-to-jax"])
def test_run_checkpoint_resume(files, jax_run, direction):
    """--checkpoint on the first half, --resume on the second: the joined
    outputs equal fdc_tpu's uninterrupted run, whichever package saves or
    resumes."""
    src, dst = direction.split("-to-")
    runs = {"port": port, "jax": jax}
    ck = str(files / f"{direction}.ckpt")
    a = runs[src]("run", files, f"{direction}_a", "a.c64",
                  ("--checkpoint", ck))
    b = runs[dst]("run", files, f"{direction}_b", "b.c64", ("--resume", ck))
    assert_same_outputs(outputs(a, b), jax_run)


@pytest.mark.parametrize("direction", ["port-to-port", "jax-to-port",
                                       "port-to-jax"])
def test_vcm_checkpoint_resume(files, jax_vcm, direction):
    src, dst = direction.split("-to-")
    runs = {"port": port, "jax": jax}
    ck = str(files / f"vcm-{direction}.ckpt")
    a = runs[src]("vcm", files, f"vcm_{direction}_a", "a.c64",
                  ("--checkpoint", ck))
    b = runs[dst]("vcm", files, f"vcm_{direction}_b", "b.c64",
                  ("--resume", ck))
    ev, _, _ = outputs(a, b)
    assert ev == jax_vcm[0]


def test_split_segment_matches_fdc_tpu(files):
    flag = ("--split-segment", "0:2:2")
    ref = outputs(jax("run", files, "jax_split", extra=flag))
    assert_same_outputs(outputs(port("run", files, "port_split",
                                     extra=flag)), ref)
    with pytest.raises(SystemExit):
        main(["run", str(files / "cfg.json"), str(files / "cap.c64"),
              "--cpu", "--split-segment", "bogus"])
    # the vcm block refuses segment_splits, as fdc_tpu's does
    with pytest.raises(SystemExit, match="segment_splits"):
        main(["vcm", str(files / "split.json"), str(files / "cap.c64"),
              "--cpu"])


def serve(files, out, extra=()):
    """``serve`` on port 0 in a thread, fed the capture by a TCP client;
    its output directory."""
    x = np.fromfile(files / "cap.c64", np.complex64)
    out = files / out
    port_file = out.with_suffix(".port")
    th = threading.Thread(target=main, daemon=True, args=([
        "serve", str(files / "cfg.json"), "--cpu", "--port", "0",
        "--port-file", str(port_file), "--out-dir", str(out),
        "--events-jsonl", str(out.with_suffix(".jsonl")), *extra],))
    th.start()
    deadline = time.time() + 60
    while not port_file.exists() or not port_file.read_text():
        assert time.time() < deadline, "serve never started listening"
        assert th.is_alive(), "serve exited before listening"
        time.sleep(0.05)
    with socket.create_connection(("127.0.0.1", int(port_file.read_text())),
                                  timeout=5) as conn:
        conn.sendall(x.tobytes())
    th.join(timeout=60)
    assert not th.is_alive(), "serve did not finish"
    return out


def test_serve_matches_fdc_tpu_run(files, jax_run):
    """serve: a TCP client streams the capture to port 0; the outputs are
    fdc_tpu's ``run`` over the file (a live waterfall on the side)."""
    png = files / "live.png"
    out = serve(files, "port_serve", ("--waterfall-follow", str(png)))
    assert_same_outputs(outputs(out), jax_run)
    assert png.exists() == have_matplotlib()


def test_serve_pipeline_matches_fdc_tpu_run(files, jax_run):
    """serve through the pipeline: three CPU lanes, the first a dedicated
    scan owner."""
    out = serve(files, "port_serve_pipe", ("--pipeline", "--cpu-devices",
                                           "3", "--dedicated-owner"))
    assert_same_outputs(outputs(out), jax_run)


def hostpipe_run(files, out):
    """``run --hostpipe-owner 1`` and ``run --hostpipe-worker 1:2`` of
    this package, each in a thread of its own, over the same capture into
    one --out-dir (the configs' fingerprints must agree); the owner's
    output directory."""
    port_file = files / f"{out}.port"
    argv = ["run", str(files / "cfg.json"), str(files / "cap.c64"), "--cpu",
            "--out-dir", str(files / out)]
    errors = []

    def call(extra):
        try:
            assert main([*argv, *extra]) == 0
        except BaseException as e:  # surfaced below
            errors.append(e)

    owner = threading.Thread(target=call, daemon=True, args=([
        "--events-jsonl", str(files / f"{out}.jsonl"), "--hostpipe-owner",
        "1", "--hostpipe-port-file", str(port_file)],))
    owner.start()
    deadline = time.time() + 60
    while not port_file.exists() or not port_file.read_text():
        assert time.time() < deadline and owner.is_alive(), errors
        time.sleep(0.05)
    worker = threading.Thread(target=call, daemon=True, args=([
        "--hostpipe-worker", "1:2", "--hostpipe-connect",
        f"127.0.0.1:{port_file.read_text()}"],))
    worker.start()
    for th in (owner, worker):
        th.join(timeout=60)
        assert not th.is_alive(), "a hostpipe end did not finish"
    assert not errors, errors
    return files / out


@pytest.mark.parametrize("flag", [
    ("--pipeline",), ("--pipeline", "2"), ("--dedicated-owner",),
    ("--pipeline-scan-owners", "2"), ("--cpu-devices", "8"),
    ("--hostpipe-owner", "1"), ("--hostpipe-worker", "0:2"),
    ("--hostpipe-connect", "127.0.0.1:1"), ("--hostpipe-port", "1"),
    ("--hostpipe-port-file", "p.txt"),
], ids=lambda f: " ".join(f))
def test_multi_device_flags_run(files, jax_run, flag):
    """Each MPMD flag does what it does in fdc_tpu: ``run`` with it gives
    the outputs of fdc_tpu's ``main()`` on the same argv, or its argument
    error. The flags that need no peer alone (the owner's listen port and
    port file, the worker's owner address, the pipeline's options without
    --pipeline) change nothing there. ``--hostpipe-owner 1`` runs with a
    worker of this package, against fdc_tpu's plain run (fdc_tpu's own
    tests hold its hostpipe run equal to that; its command-line worker
    writes empty stream files into the --out-dir the owner shares)."""
    name = "_".join(f.strip("-").replace(".", "") for f in flag)
    if flag[0] == "--hostpipe-worker":
        errors = []
        for fn in (jax_main, main):
            with pytest.raises(SystemExit) as exc:
                fn(["run", str(files / "cfg.json"), str(files / "cap.c64"),
                    "--cpu", *flag])
            errors.append(str(exc.value.code))
        assert errors[0] == errors[1] and "--hostpipe-connect" in errors[1]
        return
    if flag[0] == "--hostpipe-owner":
        assert_same_outputs(outputs(hostpipe_run(files, f"hp_{name}")),
                            jax_run)
        return
    ref = outputs(jax("run", files, f"jax_{name}", extra=flag))
    assert_same_outputs(outputs(port("run", files, f"port_{name}",
                                     extra=flag)), ref)


@pytest.mark.parametrize("flag", [
    ("--time-shards", "4", "--chan-shards", "2"),
    ("--pipeline", "4", "--pipeline-shard-time", "2"),
], ids=lambda f: " ".join(f))
def test_spmd_flags_run_as_fdc_tpus(files, flag):
    """The SPMD flags on an 8-device CPU mesh: ``run`` gives the outputs
    of fdc_tpu's ``main()`` on the same argv (tests/test_cli.py:226-235,
    the composed pipeline of :382-435)."""
    extra = ("--cpu-devices", "8", *flag)
    name = "_".join(f.strip("-") for f in flag)
    ref = outputs(jax("run", files, f"jax_{name}", extra=extra))
    assert_same_outputs(outputs(port("run", files, f"port_{name}",
                                     extra=extra)), ref)


@pytest.mark.parametrize("flag", [
    ("--time-shards", "2"), ("--chan-shards", "2"),
], ids=lambda f: " ".join(f))
def test_one_sharded_axis_runs(files, jax_run, flag):
    """One sharded axis alone (the other of size 1): fdc_tpu's plain
    run's outputs."""
    name = "_".join(f.strip("-") for f in flag)
    assert_same_outputs(outputs(port(
        "run", files, f"port1_{name}", extra=("--cpu-devices", "4", *flag))),
        jax_run)


@pytest.mark.parametrize("flag", [
    ("--time-shards", "4", "--chan-shards", "2"),
    ("--pipeline", "4", "--pipeline-shard-time", "2"),
], ids=lambda f: " ".join(f))
def test_serve_spmd_matches_fdc_tpu_run(files, jax_run, flag):
    """serve over the sharded step and the composed pipeline on 8 CPU
    devices: fdc_tpu's ``run`` over the file."""
    name = "_".join(f.strip("-") for f in flag)
    out = serve(files, f"port_serve_{name}", ("--cpu-devices", "8", *flag))
    assert_same_outputs(outputs(out), jax_run)


def test_too_few_devices_raise_the_mesh_error(files):
    """A mesh larger than the devices: the mesh's error, as fdc_tpu's
    make_mesh raises it (a two-card mesh on a one-card machine)."""
    argv = ["run", str(files / "cfg.json"), str(files / "cap.c64"),
            "--cpu-devices", "2", "--time-shards", "2", "--chan-shards", "2"]
    with pytest.raises(ValueError, match="mesh 2x2 needs 4 devices, have 2"):
        main(argv)


@pytest.mark.parametrize("extra,msg", [
    (("--pipeline", "--time-shards", "2"),
     "--pipeline and --time-shards/--chan-shards are exclusive"),
    (("--hostpipe-owner", "1", "--pipeline"), "--hostpipe-* and --pipeline"),
    (("--hostpipe-owner", "1", "--hostpipe-worker", "1:2"),
     "--hostpipe-owner and --hostpipe-worker are exclusive"),
    (("--hostpipe-worker", "bogus"), "expected HOST_ID:N_HOSTS"),
], ids=["pipeline+shards", "hostpipe+pipeline", "owner+worker",
        "worker-spec"])
def test_multi_device_exclusivity_is_fdc_tpus(files, extra, msg):
    """The flag combinations fdc_tpu refuses, refused with its message."""
    argv = ["run", str(files / "cfg.json"), str(files / "cap.c64"), "--cpu",
            *extra]
    codes = []
    for fn in (jax_main, main):
        with pytest.raises(SystemExit) as exc:
            fn(argv)
        codes.append(str(exc.value.code))
    assert codes[0] == codes[1] and msg in codes[1]


def test_without_cpu_the_cli_runs_on_the_card(files):
    """Without --cpu the CLI runs on the card: no card, no fallback."""
    import torch

    argv = ["run", str(files / "cfg.json"), str(files / "cap.c64")]
    if torch.cuda.is_available():
        assert main(argv) == 0
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)


def have_matplotlib():
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def test_run_waterfall(files):
    """run --waterfall with the style flags writes its PNG (matplotlib is
    optional: without it the CLI says so and writes none)."""
    png = files / "wf.png"
    port("run", files, "port_wf", extra=(
        "--waterfall", str(png), "--waterfall-colorscheme", "2",
        "--waterfall-db", "-80", "10", "--waterfall-tagmode", "id"))
    assert png.exists() == have_matplotlib()


@pytest.mark.parametrize("change,blocks", [
    (dict(use_mxu_fft=False), N_BLOCKS),
    # the slot width capped as the flagship's: the product route's slot
    # transform is a dense [2 w_cap, 2 w_cap] matrix in both packages
    (dict(blocksize=32768, batch_blocks=2, max_extract_width=512), 7),
], ids=["fft-route", "blocksize-32768"])
def test_config_knobs_run_as_fdc_tpus(tmp_path, change, blocks):
    """A config file with ``use_mxu_fft: false`` or ``blocksize: 32768``
    runs through ``python -m fdc_tpu_torch run`` as through fdc_tpu's."""
    from fdc_tpu_torch.config import ChannelizerConfig

    cfg = ChannelizerConfig(
        blocksize=1024, relinvovl=4,
        throughput_channels=((0.12, 0.05),),
        activity_controlled_channels=((0.22, 0.1),),
        activity_detection_segments=((0.30, 0.42),),
        batch_blocks=16, max_slots=8,
    ).replace(**change)
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    rng = np.random.default_rng(8)
    n = blocks * cfg.inplen
    t = np.arange(n)
    gate = np.zeros(n)
    gate[n // 3: 2 * n // 3] = 1.0
    x = (0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         + 0.9 * np.exp(2j * np.pi * 0.12 * t)
         + gate * (0.8 * np.exp(2j * np.pi * 0.22 * t)
                   + 0.9 * np.exp(2j * np.pi * 0.35 * t)))
    x[:-333].astype(np.complex64).tofile(tmp_path / "cap.c64")
    got = outputs(port("run", tmp_path, "port"))
    assert_same_outputs(got, outputs(jax("run", tmp_path, "jax")))
