"""Run one pytest selection several times, each run in a fresh process, and
count the runs that pass: the way a flaky test is shown fixed.

    python -m infw_torch.tools.repeat_tests --runs 30 --timeout 150 \\
        --out runs/threads -- --noconftest -m cuda tests/test_torch_cuda.py \\
        -k threads_on_their_streams -o faulthandler_timeout=50

Everything after ``--`` goes to ``python -m pytest`` (with ``-q -p
no:cacheprovider``).  A run that exceeds ``--timeout`` seconds is killed
and counts as failed (with ``-o faulthandler_timeout=N`` below the
timeout, pytest prints every thread's stack first); so does a run whose
summary reports a skip.  Each run's output goes
to ``--out``/run_<i>.txt when ``--out`` is given.  Prints one line a run
and, last, one JSON object {"runs", "passed", "failed": [run numbers],
"seconds"}.  Exits 0 when every run passed, else 1.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = []
    if "--" in argv:
        cut = argv.index("--")
        argv, extra = argv[:cut], argv[cut + 1:]
    p = argparse.ArgumentParser(prog="infw_torch.tools.repeat_tests", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--timeout", type=float, default=900.0, help="seconds a run may take")
    p.add_argument("--out", default=None, help="directory for each run's output")
    args = p.parse_args(argv)
    if args.runs < 1:
        p.error("--runs must be >= 1")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", *extra]
    failed = []
    t_start = time.perf_counter()
    for i in range(1, args.runs + 1):
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True, timeout=args.timeout)
            rc, out = proc.returncode, proc.stdout
        except subprocess.TimeoutExpired as e:
            rc = "timeout"
            out = e.stdout if isinstance(e.stdout, str) else (e.stdout or b"").decode(
                errors="replace")
        if args.out:
            with open(os.path.join(args.out, f"run_{i}.txt"), "w") as f:
                f.write(out)
        last = out.strip().splitlines()[-1] if out.strip() else ""
        # a run passes when pytest exits 0 and its summary reports passes
        # and no skip (a test skipped where it should run proves nothing)
        if rc != 0 or " passed" not in last or "skipped" in last:
            failed.append(i)
        print(f"run {i}: rc {rc} in {time.perf_counter() - t0:.1f} s: {last}", flush=True)
    print(json.dumps({"runs": args.runs, "passed": args.runs - len(failed), "failed": failed,
                      "seconds": round(time.perf_counter() - t_start, 1)}), flush=True)
    return 0 if not failed else 1


if __name__ == "__main__":
    sys.exit(main())
