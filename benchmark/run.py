"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. It makes its scenes on the card from ``--seed``, warms up, measures
for ``--seconds`` (``--trace 0``: the cell's end-to-end metrics) or runs
the traced scenes (``--trace 1``: its per-layer metrics), checks a sample
of the outputs against the plain reference, and prints one JSON line last
on standard output, with the numbers compared and their limits last on
standard error as well. Without a card it exits 1 and prints no result; if
JAX or the JAX package was loaded, it exits 3.
"""
import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every compile cache of the run stays in the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness

    bench = harness.load_benchmark(ROOT)
    w = harness.cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(w["chips"]):
        print(f"benchmark: {w['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 1
    result, lines = harness.run(bench, w, args.seed, args.seconds,
                                args.trace, "cuda", _T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: loaded {', '.join(bad)}, which the port must not "
              "load", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
