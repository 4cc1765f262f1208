"""Kernels K7 and K8 (``kernels/csrc/flow_table.cu``) beside two designs
their source rejects, on the card, at the flow ladder's 90% state.

    python -m infw_torch.tools.flow_variants

Each variant is the shipped source with one choice undone, built by nvcc
into ``build/infw_torch/flow_variants/``:

- ``eager``: a lane loads every way's se, keys and vg rows at once (the
  insert: se and keys), one round of row loads in place of three (or two);
- ``grouped``: the lanes of a warp on one slot sum their counter adds
  (``__match_any_sync``, ``__reduce_add_sync``) before the lowest of them
  adds them, in the probe's add + max phase and the insert's seed phase.

The state: a 2^17-row 4-way flow table after the 64 chunks of the 2^18
packets of ``testing.flow_trace_batch`` at 90% established (the tables
``chip_smoke.py``'s flow phase uses), each chunk probed and its misses
inserted.  Per size (4096, 65536 and 2^18 lanes of the 7-word wire), each
variant's K7 and K8 run on a clone of that table: the fused buffer, the
counts and the four columns must equal the shipped kernel's; then the
profiler's device microseconds a call (one kernel a call, 20 calls).
Prints a line per size and kernel, then one JSON line.  Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import testing
from ..kernels import _build
from ..kernels import flow as kflow

SIZES = (4096, 1 << 16, 1 << 18)
OUT = _build.BUILD_DIR / "flow_variants"

# "eager": the probe's three rounds of row loads as one
_PROBE_STAGED = """#pragma unroll
      for (int w = 0; w < MW; ++w)
        if (w < a.ways) e[w] = a.se[P.slot(w, a.S)];
#pragma unroll
      for (int w = 0; w < MW; ++w) {
        m[w] = w < a.ways && e[w].x >= kFlowEst &&
               epoch_diff(a.epoch_now, e[w].y) <= a.max_age;
        if (m[w]) {
          const uint4* r = reinterpret_cast<const uint4*>(a.keys + (size_t)P.slot(w, a.S) * 8);
          ka[w] = r[0];
          kb[w] = r[1];
        }
      }
#pragma unroll
      for (int w = 0; w < MW; ++w) {
        m[w] = m[w] && key_eq(ka[w], kb[w], L);
        if (m[w]) g[w] = a.vg[P.slot(w, a.S)];
      }
"""
_PROBE_EAGER = """#pragma unroll
      for (int w = 0; w < MW; ++w) {
        if (w < a.ways) {
          const int s = P.slot(w, a.S);
          e[w] = a.se[s];
          g[w] = a.vg[s];
          const uint4* r = reinterpret_cast<const uint4*>(a.keys + (size_t)s * 8);
          ka[w] = r[0];
          kb[w] = r[1];
        }
      }
#pragma unroll
      for (int w = 0; w < MW; ++w)
        m[w] = w < a.ways && e[w].x >= kFlowEst &&
               epoch_diff(a.epoch_now, e[w].y) <= a.max_age && key_eq(ka[w], kb[w], L);
"""
# "eager": the insert's two rounds as one
_INSERT_STAGED = """#pragma unroll
      for (int w = 0; w < MW; ++w)
        if (w < a.ways) e[w] = a.se[P.slot(w, a.S)];
#pragma unroll
      for (int w = 0; w < MW; ++w) {
        if (w < a.ways && e[w].x > 0) {
"""
_INSERT_EAGER = """#pragma unroll
      for (int w = 0; w < MW; ++w)
        if (w < a.ways) e[w] = a.se[P.slot(w, a.S)];
#pragma unroll
      for (int w = 0; w < MW; ++w) {
        if (w < a.ways) {
"""
# "grouped": the counter adds summed per warp group on a slot
_PER_LANE_ADD = """  if (k.slot < 0) return;
  add_counters(a.cnt, k.slot, k.info & kLenMask);
"""
_GROUPED_ADD = """  grouped_add(a.cnt, k.slot, k.info & kLenMask);
  if (k.slot < 0) return;
"""
_GROUPED_FN = """__device__ __forceinline__ void grouped_add(int* cnt, int slot, uint32_t len) {
  const unsigned peers = __match_any_sync(kFull, slot);
  const bool on = slot >= 0;
  const uint32_t n = __reduce_add_sync(peers, on ? 1u : 0u);
  const uint32_t hi = __reduce_add_sync(peers, on ? (len >> 8) & kLenMask : 0u);
  const uint32_t lo = __reduce_add_sync(peers, on ? len & 0xFFu : 0u);
  if (!on || (int)(threadIdx.x & 31) != __ffs(peers) - 1) return;
  int* c = cnt + (size_t)slot * 3;
  atomicAdd(c, (int)n);
  if (hi) atomicAdd(c + 1, (int)hi);
  if (lo) atomicAdd(c + 2, (int)lo);
}

// Per-warp counts into shared memory"""

VARIANTS = {
    "eager": ((_PROBE_STAGED, _PROBE_EAGER, 1), (_INSERT_STAGED, _INSERT_EAGER, 1)),
    "grouped": ((_PER_LANE_ADD, _GROUPED_ADD, 2),
                ("// Per-warp counts into shared memory", _GROUPED_FN, 1)),
}


def variant_source(name: str) -> str:
    """The shipped source with variant ``name``'s edits; raises when the
    source no longer holds the text an edit replaces."""
    src = (_build.CSRC / "flow_table.cu").read_text()
    for old, new, count in VARIANTS[name]:
        if src.count(old) != count:
            raise RuntimeError(f"flow_variants: variant {name!r} no longer applies to "
                               f"flow_table.cu (an anchor occurs {src.count(old)} times)")
        src = src.replace(old, new)
    return src


def build_variant(name: str):
    """nvcc for variant ``name`` -> (probe kernel, insert kernel) bound
    with the shipped entry points' signatures."""
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, d)
    (d / "flow_table.cu").write_text(variant_source(name))
    lib = d / "flow_table.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(d / "flow_table.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{proc.stdout}")
    so = ctypes.CDLL(str(lib))
    out = []
    for k in (kflow.PROBE_KERNEL, kflow.INSERT_KERNEL):
        fn = getattr(so, k.symbol)
        fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
        out.append(_Entry(fn))
    return out


class _Entry:
    """A variant's entry point in the place of a wrapper's kernel."""

    def __init__(self, fn) -> None:
        self.fn, self.launches = fn, 0

    def launch(self, *args) -> None:
        rc = self.fn(*args)
        if rc:
            raise RuntimeError(f"flow variant launch failed with error {rc}")


def device_us(fn, reps: int = 20) -> float:
    """The profiler's device microseconds a call of ``fn`` (kernels only),
    after a warm call; raises unless each call is one kernel."""
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
    raise RuntimeError(f"the profiler saw no clean trace of {reps} one-kernel calls")


def warm_table(device):
    """The 2^17 x 4-way table after the 90% ladder trace, and the trace."""
    tables = testing.random_tables_fast(np.random.default_rng(77), 200_000, width=8,
                                        v6_fraction=0.8, ifindexes=(2, 3))
    batch, _meta = testing.flow_trace_batch(np.random.default_rng(7790), tables, 1 << 18, 0.9,
                                            chunk_packets=4096)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)  # noqa: E731
    one = torch.zeros(1, dtype=torch.int32, device=device)
    table = kflow.empty_flow_table(1 << 17, device)
    rng = np.random.default_rng(1)
    for k, lo in enumerate(range(0, len(batch), 4096)):
        sub = batch.slice(lo, lo + 4096)
        wire_np = sub.pack_wire()
        wire, flags = put(wire_np), put(sub.tcp_flags.astype(np.int32))
        zt = torch.zeros(len(sub), dtype=torch.int32, device=device)
        fused = kflow.flow_probe(table, one, one, wire, zt, flags, k + 1, 1 << 20,
                                 slab_entries=1 << 17, ways=4)
        miss = np.nonzero(~kflow.split_flow_probe_outputs(fused.cpu().numpy(), len(sub))[1])[0]
        kflow.flow_insert(table, one, one, put(wire_np[miss]), zt[:len(miss)],
                          put(sub.tcp_flags[miss].astype(np.int32)),
                          put(rng.integers(0, 1 << 16, len(miss)).astype(np.int32)), k + 1,
                          slab_entries=1 << 17, ways=4)
    return table, batch


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("flow_variants: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    kflow.PROBE_KERNEL._entry()  # the shipped build
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        entries = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS)))
    table, batch = warm_table(device)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)  # noqa: E731
    one = torch.zeros(1, dtype=torch.int32, device=device)
    geo = {"slab_entries": 1 << 17, "ways": 4}
    shipped = kflow.PROBE_KERNEL, kflow.INSERT_KERNEL
    result = {}
    for B in SIZES:
        sub = batch.slice(len(batch) // 2, len(batch) // 2 + B) if B < len(batch) else batch
        wire, flags = put(sub.pack_wire()), put(sub.tcp_flags.astype(np.int32))
        zt = torch.zeros(B, dtype=torch.int32, device=device)
        verdict = put(np.random.default_rng(B).integers(0, 1 << 16, B).astype(np.int32))
        calls = {
            "flow_probe": lambda t: kflow.flow_probe(t, one, one, wire, zt, flags, 999, 1 << 20,
                                                     **geo),
            "flow_insert": lambda t: kflow.flow_insert(t, one, one, wire, zt, flags, verdict, 999,
                                                       **geo),
        }
        for name, call in calls.items():
            want = kflow.clone_flow_table(table)
            ref = call(want)
            mine = kflow.clone_flow_table(table)
            times = {"shipped": device_us(lambda: call(mine))}
            for variant, (probe, insert) in entries.items():
                kflow.PROBE_KERNEL, kflow.INSERT_KERNEL = probe, insert
                try:
                    got = kflow.clone_flow_table(table)
                    out = call(got)
                    torch.cuda.synchronize()
                    if not torch.equal(out, ref) or not all(
                            torch.equal(getattr(got, f), getattr(want, f)) for f in kflow.COLUMNS):
                        raise SystemExit(f"flow_variants: {variant} {name} at B={B} disagrees "
                                         f"with the shipped kernel")
                    times[variant] = device_us(lambda: call(got))
                finally:
                    kflow.PROBE_KERNEL, kflow.INSERT_KERNEL = shipped
            result.setdefault(name, {})[str(B)] = times
            print(f"{name} at B={B}: device us a call (profiler) "
                  + ", ".join(f"{v} {t:.2f}" for v, t in times.items()), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "device_us": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
