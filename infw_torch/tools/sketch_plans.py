"""Kernel K9's two plans (``kernels/csrc/sketch_update.cu``) side by side on
the card: each held equal to the plain version, then timed over a ladder of
batch sizes, which locates the crossover ``kernels/sketch.py`` keeps as
``BLOCK_PLAN_MAX_LANES``.

    python -m infw_torch.tools.sketch_plans [--sizes 256,4096,...]

Inputs: the default ``SketchSpec`` (D 4, W 2048, K 256, 4 ways, one
tenant) and the traces ``chip_smoke.py`` times K9 on: a synflood attack
trace (``testing.attack_trace_batch``, about 40% of its lanes from two
sources) and uniform ``random_batch_fast`` packets over bench_telemetry's
100,000-entry tables, with seeded verdicts.  Per size and trace, each plan
that fits (plan S up to its shared memory, plan L at every size) runs from
the same state (the trace's first call applied): its state after one call
must equal the plain version's, the winner scratch must still be -1;
then the profiler's device microseconds a call (20 calls, one kernel each;
"lost" where traces lost events) and CUDA events with the host ahead.  Prints a line per size, then one
JSON line: {"card", "sizes": {B: {trace: {plan: {"device_us", "paced_ms"}}}},
"crossover": the largest B at which plan S is no slower than plan L on
both traces}.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from .. import testing
from ..kernels import sketch as ksk

SIZES = (256, 1024, 1536, 2048, 2560, 3072, 4096, 8192, 65536, 1 << 18)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def telemetry_tables():
    """bench_telemetry's tables: 100,000 entries, width 8, 40% IPv6."""
    return testing.random_tables_fast(np.random.default_rng(1300), 100_000, width=8,
                                      v6_fraction=0.4, ifindexes=(2, 3))


def traces(tables, b: int) -> dict:
    """{"synflood", "uniform"}: K9 inputs of ``b`` lanes over ``tables``,
    int32 tensors on the CPU (wire (b, 7), tenant, flags, u32 verdicts):
    the synflood attack trace (about 40% of its lanes from 2 sources) and
    uniform random_batch_fast packets, each with the verdicts of a seeded
    draw."""
    syn, _meta = testing.attack_trace_batch(np.random.default_rng(1301), tables, b, "synflood",
                                            attack_start=0.0, chunk_packets=1)
    uni = testing.random_batch_fast(np.random.default_rng(1302), tables, b)
    uni.tcp_flags = np.random.default_rng(1303).integers(0, 32, b).astype(np.int32)
    out = {}
    for name, bt in (("synflood", syn), ("uniform", uni)):
        rng = np.random.default_rng(1304)
        res = (rng.integers(1, 3, b).astype(np.uint32)
               | (rng.integers(0, 8, b).astype(np.uint32) << 8))
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))  # noqa: E731
        out[name] = (t(bt.pack_wire()), t(np.zeros(b, np.int32)),
                     t(np.asarray(bt.tcp_flags, np.int32)), t(res))
    return out


def device_us(fn, reps: int = 20):
    """The profiler's device microseconds a call of ``fn`` (kernels only),
    after a warm call; None (not measured) when three traces in a row hold
    other than one kernel a call (a trace that lost events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not e.name.startswith(("Memset", "Memcpy"))]
        if len(kernels) == reps:
            return sum(e.time_range.elapsed_us() for e in kernels) / reps
    return None


def paced_ms(fn, reps: int = 20) -> float:
    """CUDA-event milliseconds a call with the host ahead of the card (a
    sleep kernel holds the stream while the calls are enqueued)."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def measure(sizes) -> dict:
    dev = torch.device("cuda")
    spec = ksk.SketchSpec.make()
    limit = ksk.smem_limit(dev)
    winner = ksk.empty_winner(spec, dev)
    out = {}
    pool = traces(telemetry_tables(), max(sizes))
    for b in sizes:
        out[b] = {}
        for name, full in pool.items():
            args = [x[:b].contiguous().to(dev) for x in full]
            warm = ksk.zero_state(spec, dev)
            ksk.sketch_update_plain(warm, *args, spec)
            want = ksk.SketchState(*(t.clone() for t in warm))
            ksk.sketch_update_plain(want, *args, spec)
            plans = ["L"] + (["S"] if ksk.block_plan_bytes(b, spec) <= limit else [])
            out[b][name] = {}
            for plan in plans:
                st = ksk.SketchState(*(t.clone() for t in warm))
                ksk.sketch_update(st, *args, spec, winner=winner, _plan=plan)
                torch.cuda.synchronize()
                for f in ksk.SketchState._fields:
                    if not torch.equal(getattr(st, f), getattr(want, f)):
                        raise SystemExit(f"sketch_plans: plan {plan} disagrees with the plain "
                                         f"version on {f} at B={b} ({name})")
                if not bool((winner == -1).all()):
                    raise SystemExit(f"sketch_plans: plan {plan} left its winner scratch dirty")
                fn = lambda: ksk.sketch_update(st, *args, spec, winner=winner, _plan=plan)  # noqa: E731,B023
                out[b][name][plan] = {"device_us": device_us(fn), "paced_ms": paced_ms(fn)}
        line = "; ".join(f"{n} " + ", ".join(
            f"{p} {t['device_us']:.2f} us" if t["device_us"] is not None
            else f"{p} lost (host ahead {t['paced_ms'] * 1e3:.2f} us)" for p, t in r.items())
            for n, r in out[b].items())
        print(f"K9 plans at B = {b} (plan_for: {ksk.plan_for(b, spec, limit)}): {line}",
              flush=True)
    return out


def crossover(sizes: dict) -> int:
    """The largest B at which plan S was timed and no slower than plan L on
    every trace (0 if none): device times, or the host-ahead times where a
    trace was lost."""
    def no_slower(r) -> bool:
        if "S" not in r:
            return False
        key = ("device_us" if r["S"]["device_us"] is not None and r["L"]["device_us"] is not None
               else "paced_ms")
        return r["S"][key] <= r["L"][key]

    return max([b for b, per in sizes.items() if all(no_slower(r) for r in per.values())],
               default=0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sizes", default=",".join(str(b) for b in SIZES),
                        help="comma-separated batch sizes")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("sketch_plans: needs a CUDA card", file=sys.stderr)
        return 2
    sizes = measure([int(x) for x in opts.sizes.split(",")])
    print(json.dumps({"card": card(), "sizes": sizes, "crossover": crossover(sizes),
                      "block_plan_max_lanes": ksk.BLOCK_PLAN_MAX_LANES}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
