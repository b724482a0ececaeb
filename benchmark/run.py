"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell
asks for. The last line of standard output is the result's JSON object;
the last lines of standard error give each compared number beside its
limit. A machine without them, a metric that finds nothing to read, or
JAX or the JAX package loaded by the end of the run gives a non-zero
exit and no result. See ``benchmark/harness.py``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache a library of the run could write stays at a fixed path in
# the checkout (the program's kernels build into fdc_tpu_torch/_build/)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    bench = harness.bench_file()
    cell, _, _ = harness.cell_of(bench, args.workload)
    chips = int(cell["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), T_START, chips=chips)
    except harness.BenchError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 1
    found = harness.foreign_modules()
    if found:
        print(f"benchmark: loaded {', '.join(found)}: the run must not load "
              "JAX or the JAX package", file=sys.stderr)
        return 1
    for name, c in result["compared"].items():
        print(f"{name} {c['value']:.6g} limit {c['limit']:.6g}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
