"""Kernel K10's two plans (``kernels/csrc/score_update.cu``) side by side on
the card: each held equal to the plain version, then timed over a ladder of
batch sizes, which locates the crossover ``kernels/mxu_score.py`` keeps as
``BLOCK_PLAN_MAX_LANES``.

    python -m infw_torch.tools.score_plans [--sizes 256,4096,...]

Inputs: the default ``ScoreSpec`` (4 trees of depth 3, 512 x 4-way slots,
count-min 2 x 1024, forest only, one tenant) with ``default_model``, and
the traces ``chip_smoke.py`` times K10 on: a synflood attack trace
(``testing.attack_trace_batch``, about 40% of its lanes from two sources)
and uniform ``random_batch_fast`` packets over bench_mlscore's
100,000-entry tables, with seeded verdicts.  Per size and trace, each plan
that fits (plan S up to its shared memory, plan L at every size) runs from
the same state (the trace's first call applied): its state and output
after one call must equal the plain version's and the per-slot scratch
must be back at -1 / 0; then the profiler's device microseconds a call (20
calls, one kernel each; "lost" where traces lost events) and CUDA events
with the host ahead.  Prints a line per size, then one JSON line:
{"card", "sizes": {B: {trace: {plan: {"device_us", "paced_ms"}}}},
"crossover": the largest B at which plan S is no slower than plan L on
both traces}.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import testing
from ..kernels import mxu_score as kms
from .sketch_plans import card, crossover, device_us, paced_ms, traces

SIZES = (256, 1024, 1536, 2048, 2560, 3072, 4096, 6144, 8192, 65536, 1 << 18)


def score_tables():
    """bench_mlscore's tables: 100,000 entries, width 8, 40% IPv6."""
    return testing.random_tables_fast(np.random.default_rng(2024), 100_000, width=8,
                                      v6_fraction=0.4, ifindexes=(2, 3))


def measure(sizes) -> dict:
    dev = torch.device("cuda")
    spec = kms.ScoreSpec.make()
    model = kms.model_device(kms.default_model(spec), dev)
    tparams = torch.from_numpy(kms.zero_tparams(spec)).to(dev)
    scratch = kms.empty_scratch(spec, dev)
    idle = kms.empty_scratch(spec, dev)
    limit = kms.smem_limit(dev)
    out = {}
    pool = traces(score_tables(), max(sizes))
    for b in sizes:
        out[b] = {}
        for name, full in pool.items():
            args = [x[:b].contiguous().to(dev) for x in full]
            warm = kms.ScoreOps(kms.zero_state(spec, dev), model, tparams, scratch, spec)
            kms.score_update_out_plain(warm, *args)
            want = warm._replace(state=kms.ScoreState(*(t.clone() for t in warm.state)))
            want_out = kms.score_update_out_plain(want, *args)
            plans = ["L"] + (["S"] if kms.block_plan_bytes(b, spec) <= limit else [])
            out[b][name] = {}
            for plan in plans:
                ops = warm._replace(state=kms.ScoreState(*(t.clone() for t in warm.state)))
                got_out = kms.score_update(ops, *args, plan=plan)
                torch.cuda.synchronize()
                for f in kms.ScoreState._fields:
                    if not torch.equal(getattr(ops.state, f), getattr(want.state, f)):
                        raise SystemExit(f"score_plans: plan {plan} disagrees with the plain "
                                         f"version on {f} at B={b} ({name})")
                if not torch.equal(got_out, want_out):
                    raise SystemExit(f"score_plans: plan {plan}'s output disagrees with the "
                                     f"plain version's at B={b} ({name})")
                if not torch.equal(scratch, idle):
                    raise SystemExit(f"score_plans: plan {plan} left its slot scratch dirty")
                fn = lambda: kms.score_update(ops, *args, plan=plan)  # noqa: E731,B023
                out[b][name][plan] = {"device_us": device_us(fn), "paced_ms": paced_ms(fn)}
        line = "; ".join(f"{n} " + ", ".join(
            f"{p} {t['device_us']:.2f} us" if t["device_us"] is not None
            else f"{p} lost (host ahead {t['paced_ms'] * 1e3:.2f} us)" for p, t in r.items())
            for n, r in out[b].items())
        print(f"K10 plans at B = {b} (plan_for: {kms.plan_for(b, spec, limit)}): {line}",
              flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sizes", default=",".join(str(b) for b in SIZES),
                        help="comma-separated batch sizes")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("score_plans: needs a CUDA card", file=sys.stderr)
        return 2
    sizes = measure([int(x) for x in opts.sizes.split(",")])
    print(json.dumps({"card": card(), "sizes": sizes, "crossover": crossover(sizes),
                      "block_plan_max_lanes": kms.BLOCK_PLAN_MAX_LANES}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
