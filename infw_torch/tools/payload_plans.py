"""Kernel K11's two plans (``kernels/csrc/payload_match.cu``) side by side on
the card: each held equal to the plain versions, then timed over a ladder of
batch sizes, which locates the crossover ``kernels/acmatch.py`` keeps as
``STAGED_PLAN_MAX_LANES``.

    python -m infw_torch.tools.payload_plans [--sizes 256,4096,...]

Inputs: bench_payload's automaton (64 signature patterns of 64 bytes,
``payload.signature_patterns`` with seed 11: 1024 states, 2 bitmap words)
and its traffic, a 10% attack mix of planted signatures among benign HTTP
prefixes (``payload.attack_payloads`` / ``benign_payloads``, a block of 2048
rows tiled), the length edge cases in front.  Per size, each plan runs both
entries: the classic entry's bitmaps must equal ``acmatch_plain``'s, the
resident entry's word vectors and tail (enforce mode, seeded probe words,
hit bitmap, stateless words and wire) ``acmatch_resident_plain``'s; then the
profiler's device microseconds a call (20 calls, one kernel each; "lost"
where traces lost events) and CUDA events with the host ahead.  Prints a
line per size, then one JSON line: {"card", "sizes": {B: {entry: {plan:
{"device_us", "paced_ms"}}}}, "crossover": the largest B at which plan S is
no slower than plan L on both entries}.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import payload as ppay
from ..kernels import acmatch as kac
from ..kernels.flow import pack_bits32
from ..kernels.torchpath import _pack_res16
from .sketch_plans import card, crossover, device_us, paced_ms

SIZES = (256, 4096, 16384, 65536, 131072, 196608, 1 << 18, 1 << 19)


def bench_model() -> kac.AcModel:
    """bench_payload's automaton: 64 signature patterns x 64 B, seed 11."""
    return kac.compile_patterns(ppay.signature_patterns(np.random.default_rng(11), 64, 64),
                                plen=64)


def attack_columns(model: kac.AcModel, b: int):
    """(pay (b, L) uint8, lengths (b,) int32): the 10% attack mix, tiled
    from a block of 2048 rows, the length edge cases in front."""
    L = model.spec.plen
    rng = np.random.default_rng(b)
    n = min(b, 2048)
    k = max(1, n // 10)
    pa, la = ppay.attack_payloads(rng, k, model.patterns, L)
    pb, lb = ppay.benign_payloads(rng, n - k, L)
    perm = rng.permutation(n)
    pay, lens = np.concatenate([pa, pb])[perm], np.concatenate([la, lb])[perm]
    reps = -(-b // n)
    pay = np.ascontiguousarray(np.tile(pay, (reps, 1))[:b])
    lens = np.tile(lens, reps)[:b].astype(np.int32)
    edge = np.asarray([0, -1, L + 1, 2**31 - 1, L, L - 1, -2**31, 1], np.int32)
    lens[: min(b, 8)] = edge[: min(b, 8)]
    return pay, lens


def resident_operands(b: int, device):
    """Seeded wire (failsafe ports among them), probe words, hit bitmap and
    stateless words for the resident entry."""
    rng = np.random.default_rng(b + 1)
    wire = np.zeros((b, 7), np.uint32)
    wire[:, 0] = 1 | (1 << 2) | (rng.choice([6, 17, 1], b).astype(np.uint32) << 3)
    wire[:, 1] = rng.choice([22, 68, 80, 443], b).astype(np.uint32)
    res = rng.integers(0, 3, b) | (rng.integers(0, 9, b) << 8)
    hit = rng.random(b) < 0.4
    return (torch.from_numpy(wire.view(np.int32)).to(device),
            _pack_res16(torch.from_numpy(np.where(hit, res, 7))).to(device),
            pack_bits32(torch.from_numpy(hit)).to(device),
            _pack_res16(torch.from_numpy(np.where(hit, 5, res))).to(device))


def measure(sizes) -> dict:
    dev = torch.device("cuda")
    model = bench_model()
    d = kac.model_device(model, dev)
    spec = model.spec
    pmode = torch.ones(1, dtype=torch.int32, device=dev)
    out = {}
    for b in sizes:
        pay_np, lens_np = attack_columns(model, b)
        pay, lens = torch.from_numpy(pay_np).to(dev), torch.from_numpy(lens_np).to(dev)
        ops = kac.PayloadOps(d, pmode, spec, pay, lens)
        wire, served, hit, res16 = resident_operands(b, dev)
        nh = -(-b // 32)
        want_bits = kac.acmatch_plain(d, pay, lens, spec)
        want = [served.clone(), res16.clone(), torch.zeros(2 * nh, dtype=torch.int32, device=dev)]
        kac.acmatch_resident_plain(ops, wire, want[0], hit, want[1], want[2])
        out[b] = {"classic": {}, "resident": {}}
        for plan in kac.PLANS:
            if not torch.equal(kac.acmatch(d, pay, lens, spec, plan=plan), want_bits):
                raise SystemExit(f"payload_plans: plan {plan}'s classic entry disagrees with the "
                                 f"plain version at B={b}")
            got = [served.clone(), res16.clone(), torch.full((2 * nh,), -1, dtype=torch.int32,
                                                             device=dev)]
            kac.acmatch_resident(ops, wire, got[0], hit, got[1], got[2], plan=plan)
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise SystemExit(f"payload_plans: plan {plan}'s resident entry disagrees with "
                                 f"the plain version at B={b}")
            fns = {"classic": lambda: kac.acmatch(d, pay, lens, spec, plan=plan),  # noqa: B023
                   "resident": lambda: kac.acmatch_resident(  # noqa: B023
                       ops, wire, got[0], hit, got[1], got[2], plan=plan)}
            for entry, fn in fns.items():
                out[b][entry][plan] = {"device_us": device_us(fn), "paced_ms": paced_ms(fn)}
        line = "; ".join(f"{e} " + ", ".join(
            f"{p} {t['device_us']:.2f} us" if t["device_us"] is not None
            else f"{p} lost (host ahead {t['paced_ms'] * 1e3:.2f} us)" for p, t in r.items())
            for e, r in out[b].items())
        print(f"K11 plans at B = {b} (plan_for: {kac.plan_for(b)}): {line}", flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sizes", default=",".join(str(b) for b in SIZES),
                        help="comma-separated batch sizes")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("payload_plans: needs a CUDA card", file=sys.stderr)
        return 2
    sizes = measure([int(x) for x in opts.sizes.split(",")])
    print(json.dumps({"card": card(), "sizes": sizes, "crossover": crossover(sizes),
                      "staged_plan_max_lanes": kac.STAGED_PLAN_MAX_LANES}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
