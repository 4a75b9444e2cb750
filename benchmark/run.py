"""Run one cell of the benchmark once:

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result, one JSON object; the numbers compared for `correct` close
standard error, each beside its limit. Without a card, or with fewer
cards than the cell asks for, or without the program, it exits 1 and
prints no result: it never falls back to the CPU.

A cell of several cards runs one process a card: this process is rank 0
and starts the others (`--rank`), which join through a `FileStore` in a
fresh directory under TMPDIR and post their numbers there.
"""

import time

T_START = time.time()  # the set-up starts with the process

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "dgcnn_tpu")


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return 1


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run may not load,
    compared whole (the program's own name begins with one of them)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _spawn(args, world: int, store: str) -> list:
    cmd = [sys.executable, "-m", "benchmark.run", "--workload", args.workload,
           "--seed", str(args.seed), "--seconds", str(args.seconds),
           "--trace", str(args.trace), "--store", store, "--t0", repr(T_START)]
    return [subprocess.Popen(cmd + ["--rank", str(r)], cwd=ROOT, stdout=sys.stderr)
            for r in range(1, world)]


def _reap(procs, timeout: float) -> list:
    deadline = time.monotonic() + timeout
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(0.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--store", default="", help=argparse.SUPPRESS)
    p.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    t_start = T_START if args.t0 is None else args.t0

    if not os.path.exists(os.path.join(ROOT, "BENCHMARK.json")):
        return fail(f"no BENCHMARK.json in {ROOT}")
    import torch

    from benchmark import harness

    try:
        chips = int(harness.workload(args.workload)["chips"])
    except KeyError as e:
        return fail(str(e))
    if not torch.cuda.is_available():
        return fail("CUDA is not available: the benchmark measures the card and "
                    "never runs on the CPU")
    if torch.cuda.device_count() < chips:
        return fail(f"the cell asks for {chips} cards, {torch.cuda.device_count()} found")
    try:
        import dgcnn_tpu_torch  # noqa: F401
    except ImportError as e:
        return fail(f"the program is not here: {e}")
    torch.set_num_threads(2)
    if args.rank:  # one of the other ranks of a cell of several cards
        harness.run_rank(args.workload, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", args.rank), t_start, args.rank, chips,
                         args.store)
        return 0

    store_dir = tempfile.mkdtemp(prefix="benchmark-store-") if chips > 1 else ""
    procs = _spawn(args, chips, os.path.join(store_dir, "store")) if chips > 1 else []
    try:
        result = harness.run_rank(args.workload, args.seed, args.seconds,
                                  bool(args.trace), torch.device("cuda", 0), t_start, 0,
                                  chips, os.path.join(store_dir, "store") if chips > 1
                                  else "")
        codes = _reap(procs, 120.0)
    except BaseException:
        _reap(procs, 0.0)  # the others would wait in a collective
        raise
    finally:
        if store_dir:
            shutil.rmtree(store_dir, ignore_errors=True)
    if any(codes):
        return fail(f"a rank failed: exit codes {codes}")
    bad = forbidden_modules()
    if bad:
        return fail(f"these modules were loaded and may not be: {bad}")
    for k, v in result["checks"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
