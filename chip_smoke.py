#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (infw_torch) on one CUDA card.

    python3 chip_smoke.py [--parent DIR]

``--parent DIR`` names the root of another tree of this repository (for
example a ``git archive`` of the parent commit, unpacked): its K2, K3, K3b,
K5, K6, K7 and K8 are built from its sources and, after their outputs are
held equal to this tree's, timed beside them in turns on the same inputs.

Drives the port's dense, trie and ctrie classify paths, its wire codecs,
its multi-tenant arena, its flow tier, the resident step, the telemetry
plane, anomaly scoring and the payload tier on the card and fails (non-zero exit, no result
line) on any error:

1. device: the card's name and power limit (nvidia-smi);
2. build: every hand-written kernel from its source with nvcc, one nvcc
   per source, all started together; prints ptxas register /
   shared-memory / spill lines and the count of IMMA (tensor-core)
   instructions in K1's SASS (cuobjdump -sass), which must not be 0;
3. kernel K1 against its plain PyTorch version on the card, exact
   (result, tidx) equality, at the headline shape (1000 entries x 100
   rules on ifindexes 2, 3, 4, 2^20 packets) and at the dense limit
   (4096 entries x 16 rules, 2^18 packets);
4. the dense main path: IngressNodeFirewall CR dicts -> validate ->
   compile_tables -> TorchClassifier() -> classify on 2^20 packets, with
   launch counts zeroed just before and read just after; results, XDP
   verdicts and statistics checked bit for bit against the scalar oracle
   on 4096-packet subsets;
5. dense timings with CUDA events (K1, K1 with zero rule slots: the LPM
   alone, without its ordered scan; the LPM alone under two other entry
   groupings of the same table, k-step skipping without the ifindex
   folding and all five k-steps, each held against the shipped grouping;
   its plain version, torch._int_mm of the LPM's int8 mismatch product as
   a stage-1 yardstick the port never calls), K1's profiler kernel list,
   which must be one lpm_kernel and one rule_scan_kernel per call, with
   their device times, and end-to-end classify packets/s on the host
   clock;
6. the trie path at the JAX package's bench config 3 (100,000 CIDRs x 8
   rule slots on ifindexes 2, 3, 4, 2^20 packets): kernel K2 against its
   plain version at every level count the path walks; the main path
   (TorchClassifier() picks "trie" on its own; the IPv4 chunk, then each
   IPv6 depth class, packed and classified with its (class, generation)
   token as the daemon steers them, then one unsteered classify), launch
   counts zeroed before and read after, checked against the oracle on
   4096-packet subsets classified again and on the first packets of each
   kind of the 2^20-packet runs, the statistics against a host recount; K2
   times per level count, its bound, the plain version's time, the
   steered and unsteered end-to-end times and the stage split; per level
   count the batch's depth line (walk.walk_depths: mean node rows per
   packet, the mean of the maximum over consecutive 32-packet groups, the
   histogram) and K2 on the batch permuted into order of depth (outputs
   put back and held equal to the as-is run);
7. the ctrie path at the JAX package's 10M-entry tier (bench.py
   bench_scale_10m: clean_columns_fast, 10,000,000 disjoint /24 and /48
   entries x 4 rule slots on ifindexes 2, 3, one Allow rule each, 2^19
   packets): the host build timed phase by phase with the peak RSS; kernel
   K3 against its plain version on every packet of that table and of the
   trie phase's 100K table; the main path (TorchClassifier(force_path=
   "ctrie") and TorchClassifier(compressed=True) pick "ctrie"; classify
   and the packed chunks), launch counts zeroed before and read after
   (ctrie_walk launched, trie_walk not), checked against the trie path
   (K2) on the whole batch, a host recount of the statistics and the
   HashLpmOracle on 4096-packet subsets and the first packets of the run
   (built per batch over the entries its packets can match: ColumnOracle);
   K3's fused wire-to-verdict entry against its plain version on every
   wire width and wire8, both tables, every word of the read-back buffer;
   the device pass on the main path's narrow wire, fused against the
   composition it replaced (the torch ops around the two-column K3), in
   turns, with each pass's kernels and memsets from the profiler (the fused
   pass must be one kernel and at most one memset) and the fused entry's
   bound; K3 times on both tables, its bound, the plain version's time,
   end to end and the stage split; each table's depth line
   (cwalk.walk_depths: skip steps) and K3 on its depth-sorted batch; then
   K2 at every level count and K3 against their plain versions on the
   depth-adversarial batches (testing.depth_adversarial: all deep, deep
   and root-only alternating, one deep per 32, all root-only; the known
   depths checked), with their depth lines and times;
8. the wire codecs (the JAX package's default for a 4-word chunk on the
   trie and ctrie paths): kernel K4 against its plain version, exact, at
   widths 1, 2, 4 and n around its 1024-value block and 2^20, from aligned
   and odd byte offsets; on the IPv4-compact chunk of the trie phase's batch
   (100K table, K2) and of the ctrie phase's (table A, K3), the main path
   once per ``TorchClassifier(wire_codec=...)`` ("auto", "wire8", "delta"),
   launch counts zeroed before and read after (K4 on delta chunks only),
   its wire_stats(), and results, verdicts and statistics checked against
   the narrow-wire classify of the same packets, a host recount and the
   oracle on 4096-packet subsets; a clustered chunk for each reachable
   fixed-stride plan (1 and 2 bytes) against the oracle; the stages of one
   classify per format (host pack, H2D bytes and time, device pass on CUDA
   events, D2H, host finalize, end to end); K4 times per width at 2^20
   values (CUDA events, the profiler's device time, which must list one
   launch of one kernel per call, and the host's time per call over 1000
   calls without a synchronize), its bound, the plain version and
   torch.cumsum on the same three clocks;
9. the multi-tenant ctrie arena at the JAX package's tenant bench
   (bench.py bench_tenant): 512 tenants of 64 entries (random_tables_fast,
   seeds 9000 + t) in one 514-page pool, loaded through
   TorchArenaClassifier(); a 2^20-packet mixed batch (2048 per tenant)
   plus 4096 packets of tenant ids -1 and 513 and a destroyed tenant's
   2048; kernel K3b against its plain version on every packet, and its
   fused entry on every wire width; the main path
   (classify_async_packed_tenant), launch counts zeroed before and read
   after (K3b's fused entry once, nothing else), against the per-tenant
   oracles on 8 packets per tenant, a host recount and UNDEF for every
   invalid lane; the device pass fused against composed in turns with its
   device operations, as for K3; K3b times, its bound, the plain
   version, mixed against sequential
   per-tenant dispatch, the stage split and the pool against padded
   tables; then the swap pair at 250K entries (clean_tables_fast): the
   page-table flip against a full upload, each flip checked against the
   active table's HashLpmOracle, and a destroy + compaction;
9b. the daemon with --tenants 64 (Daemon(tenants=64), threads started,
    the JAX daemon's default slab geometry, 1024 entries x 16 rule slots,
    66 pages): one creating edit file of 1000 key_adds per tenant dir,
    all landed at once (16 tenants with identical content share a page),
    then one rules-only file per tenant (49 "patch", 15 "cow"), a swap, a
    destroy and a dedup sweep that merges two re-converged clones; a
    2^20-packet classify_mixed with ids -1, >= 64, 2^32 + 1 and the
    destroyed tenant: one launch of K3b's fused entry, against the plain
    K3b on every packet and each updater's oracle; ms per create, fill,
    patch and cow on the host clock and in CUDA events, the edit-file to
    visible latency, tenant_* from /metrics, tenant-* lines in events.log;
9c. the clone-then-patch at the JAX bench's 200K entries
    (bench.py:2418-2470): "cow" against a full re-bake and "patch" on the
    private page, min of 3, the clone equal to a cold bake;
9d. the dense-family arena (512 tenants x 1024 rows x 16 slots, 1000
    entries each; kernel K6): K6's two-column entry and its fused entry on
    every wire width against the plain versions on the mixed batch
    (grouped by tenant) and on it shuffled, then on 2^20 packets of one
    tenant and on one packet per tenant; K6 against its formulation
    (arena_dense.formulation) on 16 tenants' packets; the main path (one
    call of K6's fused entry: one memset, its cooperative kernel and its
    rule scan's, per the profiler) against the oracles; K6's times on the
    grouped and the shuffled batch, the cooperative kernel's grouping,
    staging and product apart, its bound (2 x row compares x 160 at the
    int8 rate, as K1's) and row compares;
9e. the overlay side-pool: the 512-tenant ctrie arena with a dense
    side-pool of 1024 rows x 16 slots, half the tenants with overlays of
    longer prefixes; one classify launches K3b's and K6's two-column
    entries once each, against the plain composition and the oracles of
    the merged content; K6's two-column time over the side-pool;
10. incremental patches and the overlay at the churn tier, cut to 125K
    entries (K1 over the
    overlay against its plain version; the ctrie pass without the overlay
    fused against composed in turns), then edit transactions on both
    layouts (txn.TxnApplier): one 64-op transaction of the edit generator's
    full mix, bench_churn's A/B of 64 folded rules-only edits against 8
    one-edit generations per edit (interleaved, min of 2 rounds) and one folded
    flush under the profiler (host-to-device copies and kernels per
    flush), each step checked as the others;
11. the gather microbenchmark's kernel K5 (one cooperative launch: each
    table row summed once, the sums staged in shared memory, or read
    through L2 above the staging cap) against its plain version, exact, on
    both branches: tables (4096, 128), (1, 4), (4096, 4), (5000, 256) and
    (65536, 8) (above the cap), B = 1, 3, 1023, 1025, 2^20 and 2^20 + 3,
    indices outside [0, N) with the int32 edges, at the co-resident grid
    and a forced grid of 3 blocks; at B = 2^20 over (4096, 128) and
    (65536, 8) its CUDA-event time, the profiler's device time (one
    gather_rowsum_kernel and no memset a call), its bound, the plain
    version and index_select + sum; then its tool (the main path);
11b. the stateful flow tier (ROADMAP item 9) at the JAX package's flow
    bench (bench.py bench_flow): a 200K-entry v6-heavy table of 8 rule
    slots (the trie path) and a 2^17-entry 4-way flow table, 2^18 packets
    of testing.flow_trace_batch in 4096-packet chunks at 0, 50, 90 and 99%
    established; per rung every chunk's verdicts against the stateless
    classifier, then packets/s of the flow and the stateless pass in
    turns, the measured hit rate and the launches of K7, K8 and K2 per
    pass (counts zeroed before, read after); K7 and K8 against their
    plain versions chunk by chunk over the 90% trace, on its 7-word wire
    and on the 4-word wire of its IPv4 form (fused buffers, counts, all
    four columns); their times at B = 4096, 65536 and 2^18 on both wires
    (the profiler's device time, which must be one kernel and no memset a
    call; CUDA events with the host ahead of the card and in a loop; host
    us a call) beside their bounds and plain versions; the eviction storm (a
    table 8x smaller than the flow population); the dense arena of 9d
    with a flow table of 2^14 entries a page (K6 serves the misses)
    against its stateless classify, each K7 and K8 call of it replayed by
    the plain versions on a clone of its columns with the same generations,
    page table, wire, tenants, flags and verdicts; the daemon with --flow-table 2^17
    over a 1M-frame file read twice, against a stateless daemon, its
    flow_* on /metrics against the classifier's counters;
11c. the resident step and the superbatch (ROADMAP item 10): at
    bench_resident's shape (a 100K-entry table of 8 rule slots, a 2^17-entry
    flow table, 100 admissions of 32 and of 128 packets of a 90% trace)
    every admission against the multi-dispatch flow plan and the stateless
    classifier and the columns against the former after each pass, then
    the p50 per admission of the three in turns from a cold table; at the
    flow ladder's shape (11b's tables and traces) the same gate and
    packets/s of the three in turns, the launches of a resident pass (K7's
    and K8's resident entries and K2 must run, the classic K7 and K8 not);
    the resident entries against their plain versions chunk by chunk over
    the 90% trace; kernels, memsets and copies per admission of each plan
    from the profiler (one host-to-device and one device-to-host copy a
    resident admission); the entries' times beside their bounds and plain
    versions, and one graph replay's beside the eager step's, the
    stateless classify alone eager and as a graph too; the superbatch
    (K = 4, a 2^14-entry table) against four single dispatches, then
    packets/s of both; 1000 dispatches after mark_resident_warm with no
    allocation and no capture; serving while rules change (a rules-only
    edit loaded every 8th admission of the 128-packet trace: the resident
    classifier keeping its graphs, the same retiring them at every
    generation, the multi-dispatch plan and the stateless classifier in
    turns, every admission against the stateless one's); and the daemon
    with --resident over 11b's 1M-frame file read twice, its verdict
    files against the stateless daemon's and resident_* and flow_* on
    /metrics against the classifier's counters, then read again without
    and with edit files landing every 50 ms, beside a multi-dispatch flow
    daemon doing the same.  K7's and K8's kernels-line entries carry these
    readings under ``resident``;
11d. the telemetry plane (ROADMAP item 12) at the JAX package's
    bench_telemetry shape (bench.py:3613; telemetry_phase): kernel K9
    against its plain version (both entries at B = 1 to 65536, 4- and
    7-word wires, ways 1-8, depth 1-8, a saturating sat, hot keys, forced
    and co-resident grids), the synflood trace's 80 chunks of 256 packets
    through a resident classifier with the plane on (launch counts zeroed
    before and read after), gated before any timing line by verdicts equal
    with the plane off and to the oracle and by tracked twins' tensors
    equal to their HostSketchModels; throughput on against off, the
    admissions until a drained summary names the attacker, K9's times
    (events, host ahead, profiler in a fresh process, plain, bound) on
    the synflood and a uniform trace, the resident admission with the
    sketch on and off, the graph against the eager step, and the daemon
    with --resident --telemetry --trace over 11b's 1M-frame file (span
    histograms and telemetry_* on /metrics, summaries in events.log);
11e. the anomaly-scoring tier (ROADMAP item 13) at the JAX package's
    bench_mlscore shape (bench.py:4029-4083; mlscore_phase): kernel K10
    against its plain version through both entries (chained admissions at
    B = 1 to 2^18 on synflood and uniform traces, heads of 0, 8 and 64, sat
    2^31 - 1, 4 and 100 tenants, shadow and enforce, a start above sat; on
    plan_for's plan and on each plan forced, the slot scratch back at -1 /
    0 after every call), the
    60 synflood admissions of 256 through resident and multi-dispatch
    classifiers on the card and the CPU's plain versions in shadow and
    enforce (launch counts zeroed before and read after; all equal, shadow
    equal to the oracle, every rewrite a Deny with ruleId 0 off the failsafe
    cells), a model swap and mode flips with no capture, the admissions
    until a drained anomaly-verdict record names the attacker, K10's times
    (the plan per size) and both plans over a ladder of sizes
    (infw_torch.tools.score_plans: the crossover), the resident admission
    with scoring on and off, and the daemon with
    --resident --mlscore and a model dropped into models/;
11f. the payload tier (ROADMAP item 14) at the JAX package's bench_payload
    shape (bench.py:4449-4640; payload_phase): kernel K11 against its plain
    version through both entries over the card tests' grid (S 64 to 32768,
    PW 1 to 64, L 64 and 128, B = 1 to 2^18, synflood and attack columns),
    40 admissions of 256 with a 10% attack mix through resident and
    multi-dispatch classifiers on the card and the CPU's plain versions in
    shadow and enforce (launch counts zeroed before and read after; all
    equal, shadow equal to the oracle, the retained bitmaps equal to the
    naive reference, every rewrite a Deny with ruleId 0 off the failsafe
    cells and rule Denies), a pattern swap and mode flips mid-stream with no
    capture, the automaton ladder, K11's times (with --parent in turns
    against the parent's K11), the chain floor, K11's plan ladder, the
    resident admission with the tier on and off, and the daemon with
    --resident --payload default and a pattern set dropped into patterns/;
12. the port's daemon (infw_torch.daemon.Daemon, threads started): the
    headline CRs' ingress blocks as one NodeState file, then bench config
    5a's replay of the 100K trie re-adopted from a checkpoint (2 files of
    1M frames a pass); then an
    edit file of 1024 ops of the full mix into ``edits/`` (one "batch"
    flush; the edit-visible latency, the patch_txn_* counters against
    /metrics) and a 1M-frame file against the oracle of the edited
    content, then rules edits dropped while a pass is in flight (each
    packet the oracle's verdict before or after them); then an edit file
    and one pass under compressed=True (both K3 entries on the patched
    tables); every file's verdicts against the oracle on subsets and a
    host recount, stats, deny events and /metrics; launches per pass go
    on the kernels line as ``daemon_launches``;
13. one JSON ``kernels`` line (K1-K10; K3, K3b and K6 as their fused entries,
    which the main paths run, each with its two-column entry's readings
    under ``two_column``), then the device JSON as the last line.

With ``--parent``, K2 (as is and depth-sorted, every level count), K3
(tables A and B, as is and depth-sorted; the adversarial batches), K3b,
K5 (B = 2^20 over (4096, 128) and (65536, 8)), K6 (fused, grouped and shuffled; two-column, on the dense arena and
over the side-pool), K7 and K8 (every size and wire of phase 11b, on
clones of the same columns, the columns held equal too), K9 and K10 (each
timed size and trace of phases 11d and 11e) are also run from
the other tree's build on the same operands, held equal, and timed in
turns with this tree's (parent, this, this, parent).

Imports nothing of JAX or of the JAX package ``infw``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import faulthandler
import json
import os
import re
import resource
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HEADLINE_ENTRIES, HEADLINE_WIDTH, HEADLINE_PACKETS = 1000, 100, 1 << 20
LIMIT_ENTRIES, LIMIT_WIDTH, LIMIT_PACKETS = 4096, 16, 1 << 18
# bench config 3 of the JAX package (bench.py bench_trie_100k)
TRIE_ENTRIES, TRIE_WIDTH, TRIE_PACKETS = 100_000, 8, 1 << 20
# the JAX package's 10M-entry tier (bench.py bench_scale_10m)
CTRIE_ENTRIES, CTRIE_WIDTH, CTRIE_PACKETS = 10_000_000, 4, 1 << 19
ORACLE_PACKETS = 4096
# packets of each depth-adversarial batch (testing.depth_adversarial)
DEPTH_PACKETS = 1 << 18
# K4 against its plain version: sizes around its 1024-value block and the
# main path's 2^20 (timed there), each at byte offsets 0 and 1
K4_SIZES = (1, 1023, 1024, 1025, 1 << 20, (1 << 20) + 7)
# packets of each clustered chunk that takes a fixed-stride delta plan
FIXED_PACKETS = 8192
# the JAX package's tenant bench (bench.py bench_tenant): the 512-tenant
# mixed batch and the hot-swap pair (1M entries each there, 250K here for
# the script's time limit)
ARENA_TENANTS, ARENA_ENTRIES, ARENA_PER_TENANT = 512, 64, 2048
SWAP_ENTRIES, SWAP_PACKETS = 250_000, 1 << 19
# the JAX package's churn tier (bench.py bench_churn on a chip: 1M entries,
# cut to 125K for the script's time limit) and the overlay the syncer fills
# (infw/syncer.py OVERLAY_CAP)
CHURN_ENTRIES, CHURN_WIDTH, CHURN_PACKETS, CHURN_OVERLAY = 125_000, 4, 1 << 19, 1024
# one-edit generations a round of the churn A/B (bench_churn runs 64; 4
# keep the script within its time since the scoring phase's plan ladder came in)
AB_ONE_EDITS = 4
# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense int8 ops/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
#: seconds after the start at which a run still going prints every thread's
#: stack on standard error (the run's limit is 1200 s)
WATCHDOG_S = 1100


#: --parent's kernels by name (K2, K3, K3b, K5, K6's two entries, K7, K8,
#: K9's, K10's and K11's two entries), built from its sources; empty without
#: --parent
PARENT_KERNELS: dict = {}


def k6_scratchless(csrc) -> bool:
    """Whether a tree's K6 is the design before the grouped one: its
    two-column entry point's C signature has no scratch pointer (nor, then,
    a grid cap)."""
    sig = re.search(r'extern "C" int infw_arena_dense_walk\(([^)]*)\)',
                    (csrc / "arena_dense.cu").read_text())
    return "scratch" not in sig.group(1)


def k5_scratchless(csrc) -> bool:
    """Whether a tree's K5 is the design before the cooperative one (one
    warp per index): its C signature has no row-sum scratch (nor, then, a
    grid cap)."""
    sig = re.search(r'extern "C" int infw_gather_rowsum\(([^)]*)\)',
                    (csrc / "gather_rowsum.cu").read_text())
    return "sums" not in sig.group(1)


def k10_planless(csrc) -> bool:
    """Whether a tree's K10 is the five-launch design: its C entries take a
    per-lane scratch and no plan (nor, then, a grid cap)."""
    return "int plan" not in (csrc / "score_update.cu").read_text()


def k11_first_design(csrc) -> bool:
    """Whether a tree's K11 is the design that walks the dense DFA itself
    (one thread a lane, delta and matchmap as its operands): its source has
    no set-up query and no kernel layout."""
    return "infw_acmatch_query" not in (csrc / "payload_match.cu").read_text()


def flow_grid_capped(csrc) -> bool:
    """Whether a tree's K7 and K8 entry points take a grid cap (the
    cooperative design); the three-launch design's take none."""
    sig = re.search(r'extern "C" int infw_flow_probe\(([^)]*)\)',
                    (csrc / "flow_table.cu").read_text())
    return "max_grid" in sig.group(1)


class ParentFlowKernel:
    """--parent's K7 or K8 behind this tree's launch arguments: the grid
    cap before the stream is dropped for a parent whose entry point has
    none; both designs take the (B, 2) lane scratch that this tree's
    wrapper allocates behind its output."""

    def __init__(self, kernel, capped: bool) -> None:
        self.kernel, self.capped = kernel, capped

    @property
    def launches(self) -> int:
        return self.kernel.launches

    def launch(self, *args) -> None:
        self.kernel.launch(*(args if self.capped else args[:-2] + args[-1:]))


#: --parent's K7 and K8 behind this tree's launch arguments, made once
PARENT_FLOW: list = []


@contextlib.contextmanager
def parent_flow(kflow):
    """While open, this tree's K7 and K8 wrappers (checks, one allocation)
    launch --parent's kernels."""
    if not PARENT_FLOW:
        capped = flow_grid_capped(PARENT_KERNELS["flow_probe"].csrc)
        PARENT_FLOW.extend(ParentFlowKernel(PARENT_KERNELS[n], capped)
                           for n in ("flow_probe", "flow_insert"))
    mine = kflow.PROBE_KERNEL, kflow.INSERT_KERNEL
    kflow.PROBE_KERNEL, kflow.INSERT_KERNEL = PARENT_FLOW
    try:
        yield
    finally:
        kflow.PROBE_KERNEL, kflow.INSERT_KERNEL = mine


def parent_kernels(root: str) -> dict:
    """K2, K3, K3b, K5, K6, K7, K8 and K9 of the tree at ``root``, unbuilt,
    under this tree's names and C signatures; a K2 entry point without the
    trailing grid cap (``max_grid``, added with the lane-refilling walk) is
    bound without it, a K5 of the one-warp-per-index design with its own
    signature (three pointers, three ints and the stream: no row-sum
    scratch, no grid cap), a K6 of the design before the grouped one with
    its own signatures (no scratch; no grid cap on the two-column entry),
    K7 and K8 of the three-launch design without their grid cap, K9's
    two entries (the one-plan design takes a 0 where this tree passes its
    plan, and a (B, 4) lane scratch), K10's two entries (the five-launch
    design with its own signature: a per-lane scratch, no grid cap, no
    plan), and K11's two entries (the first design with its own signature:
    the dense DFA, no layout, no launch shape)."""
    import ctypes
    from pathlib import Path

    from infw_torch.kernels import (_build, acmatch, arena_dense, arena_walk, cwalk, flow,
                                    gather, mxu_score, sketch, walk)

    csrc = Path(root) / "infw_torch" / "kernels" / "csrc"
    out = {}
    for k in (walk.KERNEL, cwalk.KERNEL, arena_walk.KERNEL):
        argtypes = k.argtypes
        if k is walk.KERNEL and "int max_grid" not in (csrc / "trie_walk.cu").read_text():
            argtypes = argtypes[:-2] + argtypes[-1:]
        out[k.name] = _build.Kernel(k.name, k.symbol, argtypes, csrc=csrc)
    p, i = ctypes.c_void_p, ctypes.c_int
    k = gather.KERNEL
    out[k.name] = _build.Kernel(k.name, k.symbol,
                                [p] * 3 + [i] * 3 + [p] if k5_scratchless(csrc) else k.argtypes,
                                csrc=csrc)
    if (csrc / "arena_dense.cu").exists():
        old = k6_scratchless(csrc)
        for k, was in ((arena_dense.KERNEL, [p] * 9 + [i] * 5 + [p]),
                       (arena_dense.FUSED_KERNEL, [p] * 8 + [i] * 7 + [p])):
            out[k.name] = _build.Kernel(k.name, k.symbol, was if old else k.argtypes, csrc=csrc,
                                        source="arena_dense")
    if (csrc / "flow_table.cu").exists():
        capped = flow_grid_capped(csrc)
        for k in (flow.PROBE_KERNEL, flow.INSERT_KERNEL):
            argtypes = k.argtypes if capped else k.argtypes[:-2] + k.argtypes[-1:]
            out[k.name] = _build.Kernel(k.name, k.symbol, argtypes, csrc=csrc,
                                        source="flow_table")
    if (csrc / "sketch_update.cu").exists():
        for k in (sketch.KERNEL, sketch.RESIDENT_KERNEL):
            out[k.name] = _build.Kernel(k.name, k.symbol, k.argtypes, csrc=csrc,
                                        source="sketch_update")
    if (csrc / "score_update.cu").exists():
        old = k10_planless(csrc)
        for k in (mxu_score.KERNEL, mxu_score.RESIDENT_KERNEL):
            argtypes = [p] * 23 + [i] * 11 + [p] if old else k.argtypes
            out[k.name] = _build.Kernel(k.name, k.symbol, argtypes, csrc=csrc,
                                        source="score_update")
    if (csrc / "payload_match.cu").exists():
        old = k11_first_design(csrc)
        for k, was in ((acmatch.KERNEL, [p] * 5 + [i] * 5 + [p]),
                       (acmatch.RESIDENT_KERNEL, [p] * 10 + [i] * 6 + [p])):
            out[k.name] = _build.Kernel(k.name, k.symbol, was if old else k.argtypes, csrc=csrc,
                                        source="payload_match")
    return out


def parent_k6_run(name: str, args_fn):
    """A call of --parent's K6 entry ``name`` on the operands of this
    tree's ``args_fn`` (``arena_dense.kernel_args`` or ``fused_args``: out,
    scratch, arguments); the scratch pointer is left out for a parent
    without one."""
    import torch

    kernel = PARENT_KERNELS[name]
    at = 8 if name == "arena_dense" else 7  # the scratch pointer's position
    old = k6_scratchless(kernel.csrc)

    def run():
        out, scratch, args = args_fn()
        if old:
            args = args[:at] + args[at + 1:]
        cap = (0,) * (len(kernel.argtypes) - len(args) - 1)
        kernel.launch(*args, *cap, torch.cuda.current_stream().cuda_stream)
        del scratch
        return out

    return run


def parent_run(name: str, kernel_args):
    """A call of --parent's kernel ``name`` on the operands of this tree's
    ``kernel_args`` (its own launch count; a grid cap of 0 where the
    parent's entry point takes one)."""
    import torch

    kernel = PARENT_KERNELS[name]

    def run():
        out, args = kernel_args()
        cap = (0,) * (len(kernel.argtypes) - len(args) - 1)
        kernel.launch(*args, *cap, torch.cuda.current_stream().cuda_stream)
        return out

    return run


def parent_turns(tag: str, label: str, this_fn, parent_fn) -> dict:
    """--parent's kernel against this tree's on the same inputs: outputs
    equal, then CUDA-event times in turns (parent, this, this, parent).
    Returns {"ms": this tree's mean, "parent_ms": the parent's}."""
    import torch

    a, b = parent_fn(), this_fn()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise SystemExit(f"--parent's kernel disagrees with this tree's [{label}]")
    p1, t1, t2, p2 = (cuda_ms(fn, reps=20) for fn in (parent_fn, this_fn, this_fn, parent_fn))
    log(f"{tag} parent vs this tree [{label}], in turns: parent {p1:.4f}, {p2:.4f} ms; this "
        f"{t1:.4f}, {t2:.4f} ms; this / parent {(t1 + t2) / (p1 + p2):.3f}")
    return {"ms": (t1 + t2) / 2, "parent_ms": (p1 + p2) / 2}


def log(msg: str) -> None:
    print(msg, flush=True)


def log_phase(msg: str) -> None:
    """A phase's end, on standard output and on standard error: a run cut
    at its time limit shows in its error stream how far it came."""
    log(msg)
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)


#: the profile children started by start_child and not yet finished
CHILDREN: list = []


def start_child(name: str) -> subprocess.Popen:
    """Start ``chip_smoke.<name>()`` in a fresh process from the script's
    directory.  It imports and builds its host inputs at once, then waits
    for finish_child's go on its standard input before it touches the
    card; a parent that exits first closes that input, and the child ends."""
    proc = subprocess.Popen([sys.executable, "-c", f"import chip_smoke; chip_smoke.{name}()"],
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    proc.started = time.perf_counter()
    CHILDREN.append(proc)
    return proc


def finish_child(proc: subprocess.Popen, label: str) -> str:
    """Send ``proc`` its go and wait for it; its wall time goes to the log,
    a non-zero exit fails the run.  Returns its standard output."""
    t0 = time.perf_counter()
    out, err = proc.communicate("go\n", timeout=600)
    CHILDREN.remove(proc)
    if proc.returncode != 0:
        raise SystemExit(f"{label} failed:\n{err[-3000:]}")
    log(f"{label}: {time.perf_counter() - t0:.1f} s after its go, started "
        f"{t0 - proc.started:.1f} s before it")
    return out


def wait_for_go() -> None:
    """In a child of start_child: block until the parent's go; exit if the
    parent has gone."""
    if sys.stdin.readline().strip() != "go":
        sys.exit(3)


def stop_children() -> None:
    for proc in CHILDREN:
        proc.kill()
        proc.wait()


def run_child(argv: list, label: str) -> subprocess.CompletedProcess:
    """Run ``argv`` from the script's directory in a fresh process; its
    wall time goes to the log, a non-zero exit fails the run."""
    t0 = time.perf_counter()
    child = subprocess.run(argv, cwd=os.path.dirname(os.path.abspath(__file__)),
                           capture_output=True, text=True, timeout=600)
    if child.returncode != 0:
        raise SystemExit(f"{label} failed:\n{child.stderr[-3000:]}")
    log(f"{label}: {time.perf_counter() - t0:.1f} s in a fresh process")
    return child


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0].strip()


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_paced_ms(fn, reps: int = 20) -> float:
    """CUDA-event milliseconds per call of ``fn`` with the host ahead of
    the card: a sleep kernel holds the stream while the calls are enqueued,
    so the events time the card's work and the gaps between its launches,
    not the wrapper's host side (which paces cuda_ms at small sizes)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # about 10 ms: longer than enqueueing the calls
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profiled_kernels(fn, reps: int, counts: dict = None, memsets: dict = None):
    """torch.profiler over ``reps`` calls after a warm one: {kernel name:
    device microseconds per call}, from the CUDA events of the trace
    (kernels only, no copies or fills).  The calls run inside the recorded
    window with 20 ms of margin on each side, after a warm-up step.  A
    trace drops device events at its start, more of them the more traces
    the process has taken before (none in its first trace; on the H100
    with torch 2.11, 8 of 20 calls and at times all of them late in this
    script's run): short spin kernels,
    left out of the result, lead the calls to take those drops, and eight
    follow them.  A trace that still holds fewer of ``fn``'s kernels than
    the launches the runtime recorded for them is taken again with four
    times the lead, up to six times, and after that the result is empty
    (not measured), never a short count.  ``counts``, when given, receives
    {kernel name: launches per call}, ``memsets`` {memset event name: per
    call}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    lead = 64
    for attempt in range(6):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(0.02)
            for _ in range(lead):
                torch.cuda._sleep(1000)
            for _ in range(reps):
                fn()
            for _ in range(8):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.02)
            prof.step()
        out, launches, fills, api = {}, {}, {}, -(lead + 8)
        for e in prof.events():
            if e.is_user_annotation or e.name.startswith("ProfilerStep"):
                continue  # the schedule's step ranges, on both timelines
            if e.device_type == DeviceType.CUDA and e.name.startswith("Memset"):
                fills[e.name] = fills.get(e.name, 0) + 1
            elif (e.device_type == DeviceType.CUDA and not e.name.startswith("Memcpy")
                  and "spin_kernel" not in e.name):
                out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / reps
                launches[e.name] = launches.get(e.name, 0) + 1
            elif e.device_type == DeviceType.CPU and e.name.startswith(("cudaLaunch", "cuLaunch")):
                api += 1
        if sum(launches.values()) >= api:
            break
        log(f"profiler: {sum(launches.values())} kernels in the trace of {api} launches "
            f"after a lead of {lead} spin kernels (attempt {attempt + 1}); tracing again")
        lead *= 4
    else:
        out, launches, fills = {}, {}, {}
    if counts is not None:
        counts.update({name: n / reps for name, n in launches.items()})
    if memsets is not None:
        memsets.update({name: n / reps for name, n in fills.items()})
    return out


def sass_count(kernel, opcodes) -> int:
    """Instructions of the built library's SASS whose opcode starts with one
    of ``opcodes`` (cuobjdump -sass, beside nvcc in the toolkit)."""
    from pathlib import Path

    from infw_torch.kernels import _build

    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(kernel.library_path())],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    ops = re.findall(r"\*/\s*(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", sass)
    return sum(op.startswith(opcodes) for op in ops)


def tables_with_entries(testing, compiler, rng, n: int, width: int, ifindexes):
    """Seeded random tables holding exactly ``n`` entries after the
    compiler's masked-identity dedup."""
    want = n
    while True:
        t = testing.random_tables(rng, want, ifindexes=ifindexes, width=width)
        if t.num_entries >= n:
            content = dict(list(t.content.items())[:n])
            return compiler.compile_tables_from_content(content, rule_width=width)
        want += 256


def compare_k1(dense, torchpath, tables, batch, label: str):
    """K1 against its plain version on the card; returns the operands and
    the largest absolute difference (0 when equal)."""
    import torch

    dt = dense.build_dense_tables(tables, "cuda")
    fields, words = torchpath.packet_fields(torchpath.device_batch(batch, "cuda"))
    got = dense.dense_classify(fields, words, dt)
    want = dense.dense_classify_plain(fields, words, dt)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max().item()) if len(batch) else 0
    mism = int((got != want).any(dim=1).sum().item())
    matched = int((got[:, 1] >= 0).sum().item())
    log(f"K1 vs plain [{label}]: T={tables.num_entries} R={tables.rule_width} "
        f"B={len(batch)} mismatching packets={mism} max_abs_err={err} "
        f"lpm-matched={matched}; {k1_groups(dense, dt)}")
    if mism:
        raise SystemExit(f"K1 disagrees with its plain version at {label}")
    return dt, fields, words, err


def k1_groups(dense, dt) -> str:
    """The kernel's entry groups of ``dt``: how many, and how many of the
    entries it walks sit in folded groups (one ifindex, compared instead of
    multiplied)."""
    g = dt.groups.numpy()
    live = dt.order.cpu().numpy() >= 0
    folded = np.repeat((g[:, 1] & dense.FOLDED) != 0, g[:, 0])
    return f"{len(g)} groups, {int((folded & live).sum())} of {int(live.sum())} entries folded"


def k1_layouts(dense, dt) -> dict:
    """``dt`` in the same entry order with other groups: "k-step skipping
    alone" multiplies each folded group's ifindex word instead of comparing
    it (the constants then cover the whole key), "five k-steps" multiplies
    every key word of every row besides.  Both compute K1's function with
    more products; {name: (DenseTables, k-step rows)}."""
    import torch

    e = dt.entries.cpu().numpy().view(np.uint32)
    _, m1sum = dense.lpm_planes(e[:, 0:5], e[:, 5:10])
    const = torch.from_numpy(dense.lpm_constants(m1sum, e[:, 10].view(np.int32)))
    const = const.to(dt.lpm_const.device)
    info = dt.groups[:, 1]
    skip = dt.groups.clone()
    skip[:, 1] = torch.where((info & dense.FOLDED) != 0, (info & ~dense.FOLDED) + 1, info)
    skip[:, 2] = 0
    five = skip.clone()
    five[:, 1] = (info & dense.LONGER) | 5
    return {name: (dt._replace(lpm_const=const, groups=g), int((g[:, 0] * (g[:, 1] & 7)).sum()))
            for name, g in (("k-step skipping alone", skip), ("five k-steps", five))}


def k1_layout_times(tag: str, dense, fields, words, dt, lpm_ms: float) -> dict:
    """K1's LPM alone (zero rule slots, CUDA events) under the shipped
    groups (k-step skipping and ifindex folding) and under each of
    ``k1_layouts``, each held against the shipped layout on both columns."""
    import torch

    g = dt.groups
    rows = {"skipping + folding (shipped)": int((g[:, 0] * (g[:, 1] & 7)).sum())}
    times = {"skipping + folding (shipped)": lpm_ms}
    want = dense.dense_classify(fields, words, dt)
    for name, (var, krows) in k1_layouts(dense, dt).items():
        if not torch.equal(dense.dense_classify(fields, words, var), want):
            raise SystemExit(f"K1 with {name} disagrees with the shipped groups")
        lpm_only = var._replace(rules=var.rules[:, :0].contiguous())
        times[name] = cuda_ms(lambda: dense.dense_classify(fields, words, lpm_only), reps=20)
        rows[name] = krows
    log(f"{tag} K1 LPM alone by entry grouping (CUDA events, {dt.order.shape[0]} kernel rows): "
        + "; ".join(f"{k} {v:.4f} ms ({rows[k]} k-step rows)" for k, v in times.items()))
    return times


def k1_device(tag: str, dense, fields, words, dt) -> dict:
    """K1's profiler kernel list per call, which must be one lpm_kernel and
    one rule_scan_kernel: {kernel: device ms per call}."""
    per_call = {}
    dev_us = profiled_kernels(lambda: dense.dense_classify(fields, words, dt), reps=20,
                              counts=per_call)
    def short(name: str) -> str:
        m = re.search(r"([A-Za-z_]\w*)\(", name)
        return m.group(1) if m else name

    launches = {short(k): v for k, v in per_call.items()}
    if launches != {"lpm_kernel": 1.0, "rule_scan_kernel": 1.0}:
        raise SystemExit(f"K1: the profiler shows kernels per call {per_call}, expected one "
                         "lpm_kernel and one rule_scan_kernel")
    out = {short(k): v / 1e3 for k, v in dev_us.items()}
    log(f"{tag} K1 profiler device time per call: lpm_kernel {out['lpm_kernel'] * 1e3:.2f} us, "
        f"rule_scan_kernel {out['rule_scan_kernel'] * 1e3:.2f} us (one launch of each)")
    return out


def k1_split(tag: str, dense, fields, words, dt):
    """K1's time on its operands and with zero rule slots, where the kernel
    does the LPM only and skips the ordered scan: (full ms, LPM-only ms),
    CUDA events."""
    lpm_only = dt._replace(rules=dt.rules[:, :0].contiguous())
    k1_ms = cuda_ms(lambda: dense.dense_classify(fields, words, dt), reps=20)
    lpm_ms = cuda_ms(lambda: dense.dense_classify(fields, words, lpm_only), reps=20)
    log(f"{tag} K1 LPM only (zero rule slots, no scan): {lpm_ms:.4f} ms of K1's {k1_ms:.4f} ms "
        f"at B={fields.shape[0]} Tp={dt.entries.shape[0]} R={dt.rules.shape[1]}; the scan "
        f"{k1_ms - lpm_ms:.4f} ms")
    return k1_ms, lpm_ms


def host_ms_per_call(fn, calls: int = 1000) -> float:
    """Host-clock milliseconds per call of ``fn`` over ``calls`` calls with
    no synchronize between them: the cost of enqueueing the work."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e3


def median_s(fn, n: int = 5) -> float:
    """Median host-clock seconds of ``n`` calls after one warm call, each
    ending in a device synchronize."""
    import torch

    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def timed_stage(stages: dict, name: str, fn):
    """Run ``fn`` between two device synchronizes and record its
    host-clock seconds under ``name``."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    stages[name] = time.perf_counter() - t0
    return r


def check_recount(batch, results, stats_delta, label: str) -> None:
    """Full-batch statistics against a host recount from the verdicts."""
    if results.shape != (len(batch),) or stats_delta.shape != (1024, 4):
        raise SystemExit(f"{label}: output has the wrong shape")
    res = results.astype(np.int64)
    act, rid = res & 0xFF, (res >> 8) & 0xFFFFFF
    is_ip = (batch.kind == 1) | (batch.kind == 2)
    recount = np.zeros((1025, 4), np.int64)
    for col, a in ((0, 2), (2, 1)):
        sel = (act == a) & is_ip
        sid = np.where(rid < 1024, rid, 1024)[sel]
        np.add.at(recount[:, col], sid, 1)
        np.add.at(recount[:, col + 1], sid, batch.pkt_len[sel].astype(np.int64))
    if not np.array_equal(recount[:1024], stats_delta):
        raise SystemExit(f"{label}: statistics disagree with the verdicts")


def check_oracle(clf, reference, subsets, label: str) -> None:
    """Each subset classified again on its own: results, XDP verdicts and
    statistics bit for bit against ``reference(subset)``, an oracle's
    classify."""
    from infw_torch import testing

    for name, sub in subsets.items():
        got = clf.classify(sub, apply_stats=False)
        ref = reference(sub)
        ok = (
            np.array_equal(got.results, ref.results)
            and np.array_equal(got.xdp, ref.xdp)
            and testing.stats_dict_from_array(got.stats_delta) == ref.stats
        )
        log(f"{label} vs oracle [{name}, {len(sub)} packets]: {'equal' if ok else 'DIFFERENT'}")
        if not ok:
            raise SystemExit(f"{label} disagrees with the oracle on {name}")


def make_crs(rng):
    """IngressNodeFirewall CR dicts at the headline scale: 12 policies, each
    one ingress block of 28 source CIDRs (IPv4 and IPv6, nested prefixes)
    with rules at orders 1..99 (TCP/UDP/SCTP ports and ranges, ICMP,
    ICMPv6, a catch-all last), on three interfaces -> 1008 LPM entries."""
    crs = []
    for p in range(12):
        cidrs = []
        for c in range(28):
            if c % 3 == 2:
                words = rng.integers(0, 1 << 16, 8)
                addr = ":".join(f"{int(w):x}" for w in words)
                plen = int(rng.choice([32, 48, 64, 96, 128]))
                cidrs.append(f"{addr}/{plen}")
            else:
                octets = [10 + p, c, int(rng.integers(0, 256)), int(rng.integers(0, 256))]
                plen = int(rng.choice([16, 24, 28, 32])) if c else 8 + (p % 8)
                cidrs.append(".".join(map(str, octets)) + f"/{plen}")
        rules = []
        for order in range(1, 99):
            kind = order % 7
            action = "Deny" if rng.random() < 0.5 else "Allow"
            start = int(rng.integers(20000, 60000))
            if kind in (0, 1, 2):
                proto = ("TCP", "UDP", "SCTP")[kind]
                ports = start if rng.random() < 0.5 else f"{start}-{start + int(rng.integers(1, 3000))}"
                cfg = {"protocol": proto, proto.lower(): {"ports": ports}}
            elif kind == 3:
                cfg = {"protocol": "ICMP", "icmp": {"icmpType": int(rng.integers(0, 20)), "icmpCode": 0}}
            elif kind == 4:
                cfg = {"protocol": "ICMPv6", "icmpv6": {"icmpType": int(rng.integers(128, 140)), "icmpCode": 0}}
            else:
                # Allow over a failsafe port is admitted (webhook.go:219-223)
                cfg = {"protocol": "TCP", "tcp": {"ports": "1-30000"}}
                action = "Allow"
            rules.append({"order": order, "protocolConfig": cfg, "action": action})
        rules.append({"order": 99, "protocolConfig": {"protocol": ""}, "action": "Deny"})
        crs.append({
            "metadata": {"name": f"policy-{p}"},
            "spec": {
                "nodeSelector": {"matchLabels": {"role": "worker"}},
                "interfaces": ["eth0", "eth1", "eth2"],
                "ingress": [{"sourceCIDRs": cidrs, "rules": rules}],
            },
        })
    return crs


def steered_classify(clf, batch):
    """Classify ``batch`` as the daemon's ingest steers it: the non-IPv6
    chunk, then each IPv6 depth class with its (class, generation) token,
    each packed with pack_wire_subset.  Returns (results, xdp, stats,
    the (label, packets) of each chunk)."""
    results = np.zeros(len(batch), np.uint32)
    xdp = np.zeros(len(batch), np.int32)
    stats = np.zeros((1024, 4), np.int64)
    jobs = [(None, np.nonzero(batch.kind != 2)[0])]
    jobs += clf.v6_depth_groups(batch.ifindex, batch.ip_words, np.nonzero(batch.kind == 2)[0])
    chunks = []
    for depth, idx in jobs:
        wire, v4_only = batch.pack_wire_subset(idx)
        out = clf.classify_async_packed(wire, v4_only, depth=depth).result()
        results[idx], xdp[idx] = out.results, out.xdp
        stats += out.stats_delta
        label = "v4" if depth is None else "full depth" if depth[0] is None else f"class {depth[0]}"
        chunks.append((label, len(idx)))
    return results, xdp, stats, chunks


def trie_phase(tag: str):
    """The trie path at bench config 3; returns K2's kernels-line entry,
    the tables and the batch."""
    import torch

    from infw_torch import layout, oracle, testing
    from infw_torch.backend.cuda import TorchClassifier
    from infw_torch.kernels import all_kernels, torchpath, walk
    from infw_torch.packets import narrow_wire

    t0 = time.perf_counter()
    rng = np.random.default_rng(30)
    tables = testing.random_tables_fast(rng, TRIE_ENTRIES, ifindexes=(2, 3, 4), width=TRIE_WIDTH)
    build_s = time.perf_counter() - t0
    batch = testing.random_batch_fast(rng, tables, TRIE_PACKETS)
    levels, targets = layout.build_poptrie(tables)
    classes = layout.tune_depth_classes(tables)
    n = tables.levels
    log(f"trie tables: {tables.num_entries} entries x {tables.rule_width} rule slots, "
        f"{n} levels, built in {build_s:.2f} s; poptrie rows per level "
        f"{[lv.shape[0] for lv in levels]}, {len(targets)} targets, depth classes {classes}")

    # K2 against its plain version at every level count the path walks
    tt = walk.build_trie_tables(tables, "cuda", pad=True)  # the layout TorchClassifier serves
    fields, words = torchpath.packet_fields(torchpath.device_batch(batch, "cuda"))
    level_counts = sorted({n, layout.v4_trie_depth(n)} | {1 + d for d in classes[:-1]})
    err = 0
    for nl in level_counts:
        got = walk.trie_walk_classify(fields, words, tt, nl)
        want = walk.trie_walk_classify_plain(fields, words, tt, nl)
        torch.cuda.synchronize()
        mism = int((got != want).any(dim=1).sum().item())
        err = max(err, int((got.long() - want.long()).abs().max().item()))
        log(f"K2 vs plain [{nl} levels]: B={len(batch)} mismatching packets={mism} "
            f"max_abs_err={err} lpm-matched={int((got[:, 1] >= 0).sum().item())}")
        if mism:
            raise SystemExit(f"K2 disagrees with its plain version at {nl} levels")

    # the main path: the classifier picks the trie path on its own
    clf = TorchClassifier()
    clf.load_tables(tables)
    if clf.active_path != "trie":
        raise SystemExit(f"TorchClassifier chose {clf.active_path!r} for {TRIE_ENTRIES} entries")
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    res, xdp, stats, chunks = steered_classify(clf, batch)
    steered_launches = walk.KERNEL.launches
    out = clf.classify(batch)
    main_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    log(f"trie main path: steered chunks {chunks} + one unsteered classify({len(batch)}) in "
        f"{main_s:.3f} s (first calls), launches {launches} "
        f"(steered {steered_launches}, unsteered {launches['trie_walk'] - steered_launches}); "
        f"wire_stats {clf.wire_stats()}")
    if launches["trie_walk"] <= 0:
        raise SystemExit("kernel trie_walk was not launched on the trie main path")
    if not (np.array_equal(res, out.results) and np.array_equal(xdp, out.xdp)
            and np.array_equal(stats, out.stats_delta)):
        raise SystemExit("steered and unsteered trie classify disagree")
    check_recount(batch, out.results, out.stats_delta, "trie main path")
    hist = np.bincount(out.xdp, minlength=3)
    log(f"trie main path verdicts: drop={hist[1]} pass={hist[2]} "
        f"rule hits={int((out.results != 0).sum())}")
    groups = clf.v6_depth_groups(batch.ifindex, batch.ip_words, np.nonzero(batch.kind == 2)[0])
    check_oracle(clf, lambda sub: oracle.classify(tables, sub), {
        "mixed": batch.slice(0, ORACLE_PACKETS),
        "v4-only": batch.take(np.nonzero(batch.kind != 2)[0][:ORACLE_PACKETS]),
        "full-depth v6 class": batch.take(groups[-1][1][:ORACLE_PACKETS]),
    }, "trie main path")
    # the 2^20-packet runs themselves, on their first packets of each kind
    for name, idx in (
        ("unsteered, first packets", np.arange(ORACLE_PACKETS)),
        ("steered v4 chunk", np.nonzero(batch.kind != 2)[0][:ORACLE_PACKETS]),
        ("steered full-depth v6 class", groups[-1][1][:ORACLE_PACKETS]),
    ):
        ref = oracle.classify(tables, batch.take(idx))
        got = (out.results, out.xdp) if name.startswith("unsteered") else (res, xdp)
        ok = np.array_equal(got[0][idx], ref.results) and np.array_equal(got[1][idx], ref.xdp)
        log(f"trie 2^20-packet run vs oracle [{name}, {len(idx)} packets]: "
            f"{'equal' if ok else 'DIFFERENT'}")
        if not ok:
            raise SystemExit(f"the 2^20-packet trie run disagrees with the oracle ({name})")

    # timings: K2 per level count, its plain version, end to end, stages
    B = len(batch)
    k2_ms = {nl: cuda_ms(lambda nl=nl: walk.trie_walk_classify(fields, words, tt, nl), reps=20)
             for nl in level_counts}
    # the walk depths, and K2 on the batch in order of depth at each level count
    depths, k2_sorted_ms, k2_parent = {}, {}, {}
    for nl in level_counts:
        d = walk.walk_depths(fields, words, tt, nl)
        depths[nl] = depth_line(tag, f"K2, trie 100K, {nl} levels", d)
        k2_sorted_ms[nl], fs, ws = depth_sorted(
            lambda f, w, nl=nl: walk.trie_walk_classify(f, w, tt, nl), fields, words, d,
            f"K2, {nl} levels")
        if PARENT_KERNELS:  # as is, then depth-sorted
            k2_parent[nl] = [parent_turns(
                tag, f"K2, trie 100K, {nl} levels, {form}",
                lambda f=f, w=w, nl=nl: walk.trie_walk_classify(f, w, tt, nl),
                parent_run("trie_walk", lambda f=f, w=w, nl=nl: walk.kernel_args(f, w, tt, nl)))
                for form, f, w in (("as is", fields, words), ("depth-sorted", fs, ws))]
    plain_ms = cuda_ms(lambda: walk.trie_walk_classify_plain(fields, words, tt, n), reps=3,
                       warmup=1)
    steered_s = median_s(lambda: steered_classify(clf, batch))
    unsteered_s = median_s(lambda: clf.classify(batch))
    # the unsteered classify stage by stage (the 6-word narrow wire it ships)
    stages = {}
    wire_np = timed_stage(stages, "wire pack", lambda: narrow_wire(batch.pack_wire()))
    wire_dev = timed_stage(stages, "host-to-device copy",
                           lambda: torch.from_numpy(wire_np.view(np.int32)).to("cuda"))
    fused = timed_stage(stages, "device pass",
                        lambda: walk.classify_walk_wire_fused(tt, wire_dev, n))
    host = timed_stage(stages, "device-to-host read", lambda: fused.cpu().numpy())
    fused_ms = cuda_ms(lambda: walk.classify_walk_wire_fused(tt, wire_dev, n), reps=10)
    # the steered path's extra host work: depth grouping, take + pack per chunk
    steer = {}
    idx6 = np.nonzero(batch.kind == 2)[0]
    groups = timed_stage(steer, "depth grouping",
                         lambda: clf.v6_depth_groups(batch.ifindex, batch.ip_words, idx6))
    timed_stage(steer, "take + pack per chunk", lambda: [
        batch.pack_wire_subset(idx) for idx in [np.nonzero(batch.kind != 2)[0]]
        + [g for _, g in groups]])

    def host_finalize():
        res16, st = torchpath.split_wire_outputs(host, B)
        torchpath.merge_stats_host(st)
        return torchpath.host_finalize_wire(res16, batch.kind)

    timed_stage(stages, "host finalize", host_finalize)

    # Bound: each input read once (48 B of fields + words per packet, and
    # the table rows this batch's walks touch, each once) and the (B, 2)
    # output written once, over the HBM rate.  The per-packet node rows
    # mostly hit L2, so this is a floor.
    table_bytes = sum(t.numel() * 4 for t in tt[:6])
    touched = k2_footprint(walk, torchpath, tt, fields, words, n)
    bytes_moved = B * (48 + 8) + sum(touched.values())
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    for nl in level_counts:
        log(f"{tag} K2 trie_walk [{nl} levels]: {k2_ms[nl]:.4f} ms at B={B} "
            f"({B / k2_ms[nl] / 1e3:.1f} M packets/s); depth-sorted batch "
            f"{k2_sorted_ms[nl]:.4f} ms ({k2_sorted_ms[nl] / k2_ms[nl]:.3f}x)")
    log(f"{tag} K2 bound: {bound_ms:.4f} ms by bytes ({bytes_moved / 1e6:.1f} MB: "
        f"{B * 56 / 1e6:.1f} MB in/out + {sum(touched.values()) / 1e6:.1f} MB of the "
        f"{table_bytes / 1e6:.1f} MB of tables touched at {n} levels, in MB: "
        f"{footprint_text(touched)}); K2 at {n} levels is {k2_ms[n] / bound_ms:.1f}x its bound")
    log(f"{tag} K2 plain version [{n} levels]: {plain_ms:.4f} ms")
    log(f"{tag} trie device pass (unpack + K2 + finalize + stats + fuse, {n} levels): "
        f"{fused_ms:.4f} ms")
    log(f"{tag} trie end-to-end classify, steered ({len(chunks)} chunks): "
        f"{steered_s * 1e3:.2f} ms per {B} packets (median of 5) = "
        f"{B / steered_s / 1e6:.3f} M packets/s")
    log(f"{tag} trie end-to-end classify, unsteered: {unsteered_s * 1e3:.2f} ms per {B} "
        f"packets (median of 5) = {B / unsteered_s / 1e6:.3f} M packets/s")
    log(f"{tag} trie stages of one unsteered classify (host clock, ms): "
        + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in stages.items()))
    log(f"{tag} trie steered host work (host clock, ms): "
        + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in steer.items()))
    return {
        "name": "trie_walk",
        "route": "cuda",
        "source": "infw_torch/kernels/csrc/trie_walk.cu",
        "replaces": "infw/kernels/pallas_walk.py:480",
        "launches": launches["trie_walk"],
        "launches_steered": steered_launches,
        "launches_unsteered": launches["trie_walk"] - steered_launches,
        "mismatches": 0,
        "max_abs_err": err,
        "ms": k2_ms[n],
        "ms_by_levels": {str(nl): k2_ms[nl] for nl in level_counts},
        "ms_depth_sorted_by_levels": {str(nl): k2_sorted_ms[nl] for nl in level_counts},
        "parent_in_turns_by_levels": {str(nl): v for nl, v in k2_parent.items()},
        "depth_by_levels": {str(nl): {k: v for k, v in depths[nl].items() if k != "hist"}
                            for nl in level_counts},
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }, tables, batch


def depth_phase(tag: str):
    """K2 (at every level count) and K3 against their plain versions on the
    depth-adversarial batches (testing.depth_adversarial: a /128 chain per
    ifindex; every packet deep, deep and root-only alternating, one deep
    packet per 32, every packet leaving at the root), with each batch's
    depth line, the known depths checked, and K2 (all levels) and K3
    timed.  Returns {pattern: ms} for K2 and for K3."""
    import torch

    from infw_torch import testing
    from infw_torch.kernels import cwalk, torchpath, walk

    k2_ms, k3_ms = {}, {}
    for n, pattern in enumerate(testing.DEPTH_PATTERNS):
        tables, batch, deep = testing.depth_adversarial(np.random.default_rng(808 + n),
                                                        DEPTH_PACKETS, pattern)
        tt = walk.build_trie_tables(tables, "cuda", pad=True)
        ct = cwalk.build_ctrie_tables(tables, "cuda", pad=True)
        fields, words = torchpath.packet_fields(torchpath.device_batch(batch, "cuda"))
        deep_t = torch.from_numpy(deep).to("cuda")
        for nl in range(1, tt.n_levels + 1):
            d = walk.walk_depths(fields, words, tt, nl)
            if not torch.equal(d, torch.where(deep_t, min(nl - 1, testing.DEEP_ROWS), 0)
                               .to(torch.int32)):
                raise SystemExit(f"K2 depths of {pattern} at {nl} levels are not the known ones")
            got = walk.trie_walk_classify(fields, words, tt, nl)
            want = walk.trie_walk_classify_plain(fields, words, tt, nl)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"K2 disagrees with its plain version on {pattern} at {nl} levels")
        d3 = cwalk.walk_depths(fields, words, ct)
        if not torch.equal(d3, torch.where(deep_t, testing.DEEP_ROWS, 0).to(torch.int32)):
            raise SystemExit(f"K3 depths of {pattern} are not the known ones")
        got = cwalk.ctrie_walk_classify(fields, words, ct)
        want = cwalk.ctrie_walk_classify_plain(fields, words, ct)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit(f"K3 disagrees with its plain version on {pattern}")
        depth_line(tag, f"{pattern}, K2 at {tt.n_levels} levels and K3",
                   walk.walk_depths(fields, words, tt, tt.n_levels))
        k2_ms[pattern] = cuda_ms(lambda: walk.trie_walk_classify(fields, words, tt, tt.n_levels),
                                 reps=20)
        k3_ms[pattern] = cuda_ms(lambda: cwalk.ctrie_walk_classify(fields, words, ct), reps=20)
        if PARENT_KERNELS:
            nl = tt.n_levels
            parent_turns(tag, f"K2, {pattern}, {nl} levels",
                         lambda: walk.trie_walk_classify(fields, words, tt, nl),
                         parent_run("trie_walk", lambda: walk.kernel_args(fields, words, tt, nl)))
            parent_turns(tag, f"K3, {pattern}", lambda: cwalk.ctrie_walk_classify(fields, words, ct),
                         parent_run("ctrie_walk", lambda: cwalk.kernel_args(fields, words, ct)))
        log(f"{tag} depth-adversarial [{pattern}, {tables.num_entries} entries, B={len(batch)}, "
            f"{int(deep.sum())} deep]: K2 equal to its plain version at 1-{tt.n_levels} levels, "
            f"K3 equal (d_max {ct.d_max}); K2 [{tt.n_levels} levels] {k2_ms[pattern]:.4f} ms, "
            f"K3 {k3_ms[pattern]:.4f} ms")
    return k2_ms, k3_ms


def peak_rss_gib() -> float:
    """This process's peak resident set (getrusage: KiB on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


class TableReads:
    """Stands in for a table tensor in a plain walk (``t.shape``, ``t[idx]``)
    and records the row indices the walk reads, so that the walk tells
    which rows of the table a batch touches."""

    def __init__(self, t):
        self.t, self.shape, self.reads = t, t.shape, []

    def __getitem__(self, idx):
        self.reads.append(idx.reshape(-1))
        return self.t[idx]

    def bytes_read(self) -> int:
        """Distinct rows read x bytes per row."""
        import torch

        if not self.reads:
            return 0
        rows = torch.unique(torch.cat(self.reads)).numel()
        return rows * int(np.prod(self.t.shape[1:])) * self.t.element_size()


def k2_footprint(walk, torchpath, tt, fields, words, n_levels: int) -> dict:
    """The bytes of the trie tables that K2 must read for this batch at
    ``n_levels`` levels, each row once however many packets share it: the
    root-LUT entries, DIR-16 slots, node rows and target entries the plain
    walk reads, the level offsets, and the rule rows of the matched entries
    (none for packets without a match).  The plain walk reads every lane,
    so a lane that has stopped may add its clamped row: at most one row of
    each table."""
    import torch

    levels = [TableReads(t) for t in tt.levels(n_levels)]
    targets, lut = TableReads(tt.targets), TableReads(tt.root_lut)
    tidx = torch.cat([
        torchpath.trie_walk(levels, targets, lut, torchpath.batch_from_fields(
            fields[s:s + walk.PLAIN_CHUNK], words[s:s + walk.PLAIN_CHUNK]))
        for s in range(0, fields.shape[0], walk.PLAIN_CHUNK)])
    matched = torch.unique(tidx[(tidx >= 0) & (tidx < tt.rules.shape[0])]).numel()
    return {
        "root LUT": lut.bytes_read(), "DIR-16 slots": levels[0].bytes_read(),
        "node rows": sum(lv.bytes_read() for lv in levels[1:]),
        "level offsets": (n_levels - 1) * 8, "targets": targets.bytes_read(),
        "rule rows": matched * tt.rules[0].numel() * 4,
    }


def k3_footprint(cwalk, torchpath, ct, fields, words) -> dict:
    """The bytes of the ctrie tables that K3 must read for this batch, each
    row once however many packets share it: the root-LUT entries, DIR-16
    slots, node rows and target entries the plain walk reads, and the
    joined rows of the matched entries (none for packets without a match).
    The plain walk reads every lane, so a lane that has stopped may add its
    clamped row: at most one row of each table."""
    import torch

    rec = cwalk.CTrieTables(TableReads(ct.root_lut), TableReads(ct.l0), TableReads(ct.nodes),
                            TableReads(ct.targets), ct.joined, ct.d_max)
    sel = torch.cat([
        torchpath.ctrie_walk_rows(rec, torchpath.batch_from_fields(
            fields[s:s + cwalk.PLAIN_CHUNK], words[s:s + cwalk.PLAIN_CHUNK]), ct.d_max)[1]
        for s in range(0, fields.shape[0], cwalk.PLAIN_CHUNK)])
    matched = torch.unique(sel[(sel > 0) & (sel < ct.joined.shape[0])]).numel()
    return {
        "root LUT": rec.root_lut.bytes_read(), "DIR-16 slots": rec.l0.bytes_read(),
        "node rows": rec.nodes.bytes_read(), "targets": rec.targets.bytes_read(),
        "joined rows": matched * ct.joined.shape[1] * 2,
    }


def footprint_text(parts: dict) -> str:
    return ", ".join(f"{k} {v / 1e6:.3f}" for k, v in parts.items())


def depth_line(tag: str, label: str, depths) -> dict:
    """Print and return the walk depths of a batch: the mean node rows (K2)
    or skip steps (K3) per packet, the mean over consecutive 32-packet
    groups (one warp's packets in the one-thread-per-packet kernels) of
    their maximum, and the histogram."""
    import torch

    d = depths.to(torch.int64)
    groups = torch.nn.functional.pad(d, (0, -d.numel() % 32)).view(-1, 32)
    out = {"mean": d.float().mean().item(),
           "warp_max_mean": groups.max(dim=1).values.float().mean().item(),
           "hist": torch.bincount(d).tolist()}
    log(f"{tag} depth [{label}]: mean {out['mean']:.4f} rows per packet, mean of the 32-packet "
        f"group maximum {out['warp_max_mean']:.4f}, histogram {out['hist']}")
    return out


def depth_sorted(run, fields, words, depths, label: str):
    """``run(fields, words)`` on the batch permuted into order of walk
    depth: its outputs, put back in batch order, must equal the as-is
    run's.  Returns (its CUDA-event time, the permutation not timed; the
    permuted fields and words)."""
    import torch

    order = torch.argsort(depths, stable=True)
    fs, ws = fields[order].contiguous(), words[order].contiguous()
    back = torch.empty_like(run(fs, ws))
    back[order] = run(fs, ws)
    want = run(fields, words)
    torch.cuda.synchronize()
    if not torch.equal(back, want):
        raise SystemExit(f"the depth-sorted run disagrees with the as-is run [{label}]")
    return cuda_ms(lambda: run(fs, ws), reps=20), fs, ws


def compare_k3(cwalk, ct, fields, words, label: str) -> int:
    """K3 against its plain version on every packet; returns the largest
    absolute difference (0 when equal)."""
    import torch

    got = cwalk.ctrie_walk_classify(fields, words, ct)
    want = cwalk.ctrie_walk_classify_plain(fields, words, ct)
    torch.cuda.synchronize()
    mism = int((got != want).any(dim=1).sum().item())
    err = int((got.long() - want.long()).abs().max().item())
    log(f"K3 vs plain [{label}]: B={fields.shape[0]} mismatching packets={mism} "
        f"max_abs_err={err} lpm-matched={int((got[:, 1] >= 0).sum().item())}")
    if mism:
        raise SystemExit(f"K3 disagrees with its plain version on {label}")
    return err


def composed_ctrie(cwalk, torchpath, ct, wire):
    """The ctrie device pass as it was composed before K3's fused entry:
    unpack_wire, packet_fields, the two-column K3, finalize (verdict,
    result_stats' index_add_) and fuse_wire_outputs."""
    res, _xdp, stats = cwalk.classify_ctrie(ct, torchpath.unpack_wire(wire))
    return torchpath.fuse_wire_outputs(res & 0xFFFF, stats)


def composed_arena(arena_walk, torchpath, pool, wire, tenant, **kw):
    """The arena device pass as it was composed before K3b's fused entry
    (composed_ctrie's ops around the two-column K3b)."""
    res, _xdp, stats = arena_walk.classify_arena_ctrie(pool, torchpath.unpack_wire(wire), tenant,
                                                       **kw)
    return torchpath.fuse_wire_outputs(res & 0xFFFF, stats)


def fused_wires(batch, tenant=None) -> dict:
    """{width: (wire, ifmap or None, tenant or None, rows)} on the card for
    every width of the fused entries: 7 and 6 (narrow) on the packets
    whose ifindex fits 16 bits (6) or all (7), 4, 3 (narrow) and wire8 (2)
    on the IPv4-compactable ones, each also with its tenant column when
    ``tenant`` is given (no wire8 then)."""
    import torch

    from infw_torch.packets import narrow_wire, wire8

    ok = (batch.ifindex >= 0) & (batch.ifindex < 1 << 16)
    v4 = np.nonzero(ok & (batch.kind != 2) & ~batch.ip_words[:, 1:].any(axis=1))[0]
    rows = {7: np.arange(len(batch)), 6: np.nonzero(ok)[0], 4: v4, 3: v4}
    if tenant is None:
        rows[2] = v4
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to("cuda")
    out = {}
    for width, idx in rows.items():
        sub = batch.take(idx)
        wire = sub.pack_wire_v4() if width in (2, 3, 4) else sub.pack_wire()
        wire = narrow_wire(wire) if width in (3, 6) else wire
        ifmap = None
        if width == 2:
            wire, ifmap = wire8(wire)
            ifmap = put(ifmap)
        out[width] = (put(wire), ifmap, None if tenant is None else put(tenant[idx]), idx)
    return out


def check_fused(label: str, run, plain, B: int) -> int:
    """A fused entry against its plain version on the card, every word of
    the read-back buffer; returns the largest absolute difference (0)."""
    import torch

    got, want = run(), plain()
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise SystemExit(f"{label}: buffer {tuple(got.shape)} against {tuple(want.shape)}")
    mism = int((got != want).sum().item())
    err = int((got.long() - want.long()).abs().max().item()) if got.numel() else 0
    log(f"{label} vs plain: B={B}, {got.numel()} words, mismatching words={mism}, "
        f"max_abs_err={err}, result words non-zero={int((got[:(B + 1) // 2] != 0).sum().item())}")
    if mism:
        raise SystemExit(f"{label} disagrees with its plain version")
    return err


def fused_turns(tag: str, label: str, fused_fn, composed_fn) -> dict:
    """The fused device pass against the composition it replaces (the torch
    ops around the two-column kernel) on the same wire: buffers equal,
    CUDA-event times in turns (composed, fused, fused, composed), and each
    pass's device operations from the profiler (kernels and memsets per
    call; the fused pass must be one kernel and at most one memset).
    Returns the readings."""
    import torch

    a, b = composed_fn(), fused_fn()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise SystemExit(f"the fused pass disagrees with the composed one [{label}]")
    c1, f1, f2, c2 = (cuda_ms(fn, reps=20) for fn in (composed_fn, fused_fn, fused_fn,
                                                     composed_fn))
    ops = {}
    for name, fn in (("fused", fused_fn), ("composed", composed_fn)):
        counts, fills, by_name = {}, {}, {}
        dev_us = profiled_kernels(fn, reps=10, counts=counts, memsets=fills)
        for k, v in counts.items():  # launches per call by kernel name, cut short
            by_name[k[:48]] = by_name.get(k[:48], 0) + v
        ops[name] = {"kernels_per_call": sum(counts.values()) if dev_us else None,
                     "memsets_per_call": sum(fills.values()) if dev_us else None,
                     "device_us": sum(dev_us.values()) if dev_us else None,
                     "kernels": by_name}
    log(f"{tag} device pass in turns [{label}]: composed {c1:.4f}, {c2:.4f} ms; fused "
        f"{f1:.4f}, {f2:.4f} ms; fused / composed {(f1 + f2) / (c1 + c2):.3f}")
    for name, o in ops.items():
        log(f"{tag} device operations per pass [{label}, {name}]: "
            + ("not measured (no device events in the trace)" if o["device_us"] is None else
               f"{o['kernels_per_call']:g} kernels + {o['memsets_per_call']:g} memsets, device "
               f"{o['device_us']:.2f} us; {o['kernels']}"))
    f = ops["fused"]
    if f["device_us"] is not None and (f["kernels_per_call"] != 1 or f["memsets_per_call"] > 1):
        raise SystemExit(f"the fused pass is not one kernel and at most one memset [{label}]")
    return {"fused_ms": (f1 + f2) / 2, "composed_ms": (c1 + c2) / 2, "ops": ops}


def fused_bound(wire, tenant, touched: dict) -> tuple:
    """The fused entry's bytes bound (ms) and its I/O bytes: the wire and
    tenant column read once, ceil(B/2) result words and the 24 KiB of
    statistics written once, plus the table rows the looked-up lanes'
    walks touch."""
    B = wire.shape[0]
    io = (wire.numel() * 4 + (0 if tenant is None else B * 4) + (B + 1) // 2 * 4
          + (0 if wire.shape[1] == 2 else 6144 * 4))
    return (io + sum(touched.values())) / HBM_BYTES_PER_S * 1e3, io


def looked_up_operands(torchpath, wire, ifmap=None):
    """(fields, words, mask) of a wire, decoded by the plain unpack on the
    card; ``mask`` marks the lanes whose walk the fused entries run (IP
    with an L4 header)."""
    batch = (torchpath.unpack_wire(wire) if ifmap is None
             else torchpath.unpack_wire8(wire, ifmap))
    fields, words = torchpath.packet_fields(batch)
    mask = ((fields[:, 0] == 1) | (fields[:, 0] == 2)) & (fields[:, 6] != 0)
    return fields, words, mask


def ctrie_table_a() -> dict:
    """The ctrie phase's table A on the host (no device work, so it runs
    while the kernels build): clean /24 + /48 columns, Allow-only,
    ifindexes 2 and 3, compiled, its host layouts built (memoized on the
    tables), and its batch; each stage timed on the host clock."""
    from infw_torch import compiler, layout, testing

    build = {}
    rng = np.random.default_rng(2024)
    cols = timed_stage(build, "corpus", lambda: testing.clean_columns_fast(
        rng, CTRIE_ENTRIES, width=CTRIE_WIDTH))
    # the compile's two parts: the arrays (compiler._compile_columns, timed
    # by a wrapper for this call) and the {LpmKey: rules} content map after
    arrays_s = []
    compile_columns = compiler._compile_columns

    def timed_compile_columns(*args, **kwargs):
        t0 = time.perf_counter()
        out = compile_columns(*args, **kwargs)
        arrays_s.append(time.perf_counter() - t0)
        return out

    compiler._compile_columns = timed_compile_columns
    try:
        tables = timed_stage(build, "compile", lambda: compiler.compile_tables_from_columns(
            cols, rule_width=CTRIE_WIDTH))
    finally:
        compiler._compile_columns = compile_columns
    del cols
    timed_stage(build, "build_poptrie", lambda: layout.build_poptrie(tables))
    _l0, nodes, _targets, d_max = timed_stage(build, "build_cpoptrie",
                                              lambda: layout.build_cpoptrie(tables))
    timed_stage(build, "joined rows", lambda: layout.joined_by_tidx(tables))
    batch = testing.random_batch_fast(rng, tables, CTRIE_PACKETS)
    return {"tables": tables, "batch": batch, "build": build, "arrays_s": arrays_s[0],
            "nodes": nodes, "d_max": d_max}


def ctrie_phase(tag: str, trie_tables, trie_batch, table_a: dict):
    """The ctrie path at the JAX package's 10M-entry tier (table A, built
    on the host by ctrie_table_a), with K3 also held against its plain
    version on the trie phase's 100K table (table B, deep /128 skip
    chains); returns K3's kernels-line entry, table A, its batch and its
    HashLpmOracle."""
    import torch

    from infw_torch.backend.cuda import TorchClassifier
    from infw_torch.kernels import all_kernels, cwalk, torchpath
    from infw_torch.packets import narrow_wire

    tables, batch, build = table_a["tables"], table_a["batch"], table_a["build"]
    nodes, d_max = table_a["nodes"], table_a["d_max"]
    ct = timed_stage(build, "upload", lambda: cwalk.build_ctrie_tables(tables, "cuda",
                                                                              pad=True))
    table_bytes = sum(t.numel() * t.element_size() for t in ct[:5])
    log(f"ctrie table A: {tables.num_entries} entries x {tables.rule_width} rule slots, "
        f"{tables.levels} trie levels; {nodes.shape[0]} node rows, "
        f"{int((nodes[:, 2] > 0).sum())} skip nodes, d_max {d_max}; device tables "
        f"{table_bytes / 1e6:.1f} MB (l0 {ct.l0.numel() * 4 / 1e6:.1f}, nodes "
        f"{ct.nodes.numel() * 4 / 1e6:.1f}, targets {ct.targets.numel() * 4 / 1e6:.1f}, "
        f"joined {ct.joined.numel() * 2 / 1e6:.1f})")
    log("ctrie table A build (host clock, s; all but the upload while the kernels built): "
        + ", ".join(f"{k} {v:.2f}" for k, v in build.items())
        + f"; compile split: arrays {table_a['arrays_s']:.2f}, "
        f"content map {build['compile'] - table_a['arrays_s']:.2f}")
    log(f"host memory after the build: peak RSS {peak_rss_gib():.2f} GiB of "
        f"{os.sysconf('SC_PAGE_SIZE') * os.sysconf('SC_PHYS_PAGES') / 2**30:.2f} GiB host RAM")

    # 1. K3 against its plain version, every packet of both tables
    fields, words = torchpath.packet_fields(torchpath.device_batch(batch, "cuda"))
    ct_b = cwalk.build_ctrie_tables(trie_tables, "cuda", pad=True)
    fields_b, words_b = torchpath.packet_fields(torchpath.device_batch(trie_batch, "cuda"))
    log(f"ctrie table B: the trie phase's {trie_tables.num_entries} entries, "
        f"{ct_b.nodes.shape[0]} node rows, "
        f"{int((ct_b.nodes[:, 2] != 0).sum().item())} skip nodes, d_max {ct_b.d_max}")
    label_a = f"table A, {tables.num_entries} entries"
    label_b = f"table B, {trie_tables.num_entries} entries"
    err = max(compare_k3(cwalk, ct, fields, words, label_a),
              compare_k3(cwalk, ct_b, fields_b, words_b, label_b))
    # K3's fused entry against its plain version on every width, both tables
    wires = {"A": fused_wires(batch), "B": fused_wires(trie_batch)}
    fused_err = 0
    for key, ct_, label in (("A", ct, label_a), ("B", ct_b, label_b)):
        for width, (w, ifmap, _t, _idx) in wires[key].items():
            if ifmap is None:
                run = lambda w=w, ct_=ct_: cwalk.classify_ctrie_wire_fused(ct_, w)
                plain = lambda w=w, ct_=ct_: cwalk.classify_ctrie_wire_fused_plain(ct_, w)
            else:
                run = lambda w=w, m=ifmap, ct_=ct_: cwalk.classify_ctrie_wire8(ct_, w, m)
                plain = lambda w=w, m=ifmap, ct_=ct_: cwalk.classify_ctrie_wire8_plain(ct_, w, m)
            fused_err = max(fused_err, check_fused(f"fused K3 [{label}, width {width}]", run,
                                                   plain, w.shape[0]))

    # 2. the main path: both knobs pick the ctrie path; the trie path (K2)
    # on the same table is the cross-check
    loads = {}
    clf = TorchClassifier(force_path="ctrie")
    timed_stage(loads, "force_path='ctrie'", lambda: clf.load_tables(tables))
    comp = TorchClassifier(compressed=True)
    timed_stage(loads, "compressed=True", lambda: comp.load_tables(tables))
    trie = TorchClassifier(force_path="trie")
    timed_stage(loads, "force_path='trie' (K2)", lambda: trie.load_tables(tables))
    if (clf.active_path, comp.active_path, trie.active_path) != ("ctrie", "ctrie", "trie"):
        raise SystemExit(f"paths chosen: {clf.active_path}, {comp.active_path}, "
                         f"{trie.active_path}; expected ctrie, ctrie, trie")
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    out = clf.classify(batch)
    out_c = comp.classify(batch)
    idx6 = np.nonzero(batch.kind == 2)[0]
    packed = {"results": np.zeros(len(batch), np.uint32), "xdp": np.zeros(len(batch), np.int32),
              "stats": np.zeros((1024, 4), np.int64)}
    jobs = [(None, np.nonzero(batch.kind != 2)[0])]
    jobs += clf.v6_depth_groups(batch.ifindex, batch.ip_words, idx6)
    for depth, idx in jobs:
        wire, v4_only = batch.pack_wire_subset(idx)
        o = clf.classify_async_packed(wire, v4_only, apply_stats=False, depth=depth).result()
        packed["results"][idx], packed["xdp"][idx] = o.results, o.xdp
        packed["stats"] += o.stats_delta
    main_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    log(f"ctrie main path: classify({len(batch)}) by force_path='ctrie' and by "
        f"compressed=True, then {len(jobs)} packed chunks, in {main_s:.3f} s (first calls), "
        f"launches {launches}; wire_stats {clf.wire_stats()}")
    if launches["ctrie_wire_fused"] <= 0 or launches["trie_walk"] != 0:
        raise SystemExit("the ctrie main path must launch ctrie_wire_fused and never trie_walk")
    ref = trie.classify(batch)
    for name, got in (("compressed=True", (out_c.results, out_c.xdp, out_c.stats_delta)),
                      ("packed chunks", (packed["results"], packed["xdp"], packed["stats"])),
                      ("trie path (K2)", (ref.results, ref.xdp, ref.stats_delta))):
        if not all(np.array_equal(a, b) for a, b in
                   zip((out.results, out.xdp, out.stats_delta), got)):
            raise SystemExit(f"ctrie main path disagrees with {name}")
        log(f"ctrie main path vs {name} [{len(batch)} packets]: equal")
    check_recount(batch, out.results, out.stats_delta, "ctrie main path")
    hist = np.bincount(out.xdp, minlength=3)
    log(f"ctrie main path verdicts: drop={hist[1]} pass={hist[2]} "
        f"rule hits={int((out.results != 0).sum())}")
    hashed = timed_stage(loads, "ColumnOracle", lambda: ColumnOracle(tables))
    check_oracle(clf, hashed.classify, {
        "mixed": batch.slice(0, ORACLE_PACKETS),
        "v4-only": batch.take(np.nonzero(batch.kind != 2)[0][:ORACLE_PACKETS]),
        "v6-only": batch.take(idx6[:ORACLE_PACKETS]),
    }, "ctrie main path")
    first = hashed.classify(batch.slice(0, ORACLE_PACKETS))
    if not (np.array_equal(out.results[:ORACLE_PACKETS], first.results)
            and np.array_equal(out.xdp[:ORACLE_PACKETS], first.xdp)):
        raise SystemExit("the timed ctrie run disagrees with the oracle on its first packets")
    log(f"ctrie {len(batch)}-packet run vs oracle [first {ORACLE_PACKETS} packets]: equal")
    log("ctrie loads and oracle build (host clock, s): "
        + ", ".join(f"{k} {v:.2f}" for k, v in loads.items())
        + f"; peak RSS now {peak_rss_gib():.2f} GiB")

    # 3. timings: K3 on both tables, its plain version, the device pass,
    # end to end and the stage split
    B = len(batch)
    k3_ms = cuda_ms(lambda: cwalk.ctrie_walk_classify(fields, words, ct), reps=20)
    k3_b_ms = cuda_ms(lambda: cwalk.ctrie_walk_classify(fields_b, words_b, ct_b), reps=20)
    # the skip steps per packet, and K3 on each batch in order of depth
    k3_depth, k3_sorted_ms, k3_parent = {}, {}, {}
    for key, label, ct_, f_, w_ in (("A", label_a, ct, fields, words),
                                    ("B", label_b, ct_b, fields_b, words_b)):
        d = cwalk.walk_depths(f_, w_, ct_)
        k3_depth[key] = depth_line(tag, f"K3, {label}", d)
        k3_sorted_ms[key], fs, ws = depth_sorted(
            lambda f, w, ct_=ct_: cwalk.ctrie_walk_classify(f, w, ct_), f_, w_, d, f"K3, {label}")
        if PARENT_KERNELS:  # as is, then depth-sorted
            k3_parent[key] = [parent_turns(
                tag, f"K3, {label}, {form}",
                lambda f=f, w=w, ct_=ct_: cwalk.ctrie_walk_classify(f, w, ct_),
                parent_run("ctrie_walk", lambda f=f, w=w, ct_=ct_: cwalk.kernel_args(f, w, ct_)))
                for form, f, w in (("as is", f_, w_), ("depth-sorted", fs, ws))]
    # where table A's chains are served from: the same table, the same
    # packet count, but the first 4096 packets repeated, so the rows the
    # walks read (a few MB) stay in the 50 MB L2 after their first reads
    hot = torch.arange(B, device=fields.device) % ORACLE_PACKETS
    fields_hot, words_hot = fields[hot].contiguous(), words[hot].contiguous()
    k3_hot_ms = cuda_ms(lambda: cwalk.ctrie_walk_classify(fields_hot, words_hot, ct), reps=20)
    plain_ms = cuda_ms(lambda: cwalk.ctrie_walk_classify_plain(fields, words, ct), reps=3,
                       warmup=1)
    plain_b_ms = cuda_ms(lambda: cwalk.ctrie_walk_classify_plain(fields_b, words_b, ct_b),
                         reps=3, warmup=1)
    e2e_s = median_s(lambda: clf.classify(batch))
    stages = {}
    wire_np = timed_stage(stages, "wire pack", lambda: narrow_wire(batch.pack_wire()))
    wire_dev = timed_stage(stages, "host-to-device copy",
                           lambda: torch.from_numpy(wire_np.view(np.int32)).to("cuda"))
    fused = timed_stage(stages, "device pass",
                        lambda: cwalk.classify_ctrie_wire_fused(ct, wire_dev))
    host = timed_stage(stages, "device-to-host read", lambda: fused.cpu().numpy())
    # the device pass: K3's fused entry against the composition it replaced
    # (unpack_wire, the two-column K3, finalize, stats, fuse), in turns, on
    # the main path's narrow wire of both tables
    turns = {}
    for key, ct_, label in (("A", ct, label_a), ("B", ct_b, label_b)):
        w = wires[key][6][0]
        turns[key] = fused_turns(
            tag, f"ctrie, {label}, {w.shape[0]} packets, narrow wire",
            lambda w=w, ct_=ct_: cwalk.classify_ctrie_wire_fused(ct_, w),
            lambda w=w, ct_=ct_: composed_ctrie(cwalk, torchpath, ct_, w))
    fused_ms = turns["A"]["fused_ms"]

    def host_finalize():
        res16, st = torchpath.split_wire_outputs(host, B)
        torchpath.merge_stats_host(st)
        return torchpath.host_finalize_wire(res16, batch.kind)

    timed_stage(stages, "host finalize", host_finalize)

    # 4. the bound, by bytes: 56 B per packet in and out, plus the table
    # rows this batch's walks touch, each once
    def bound(ct_, fields_, words_):
        touched = k3_footprint(cwalk, torchpath, ct_, fields_, words_)
        io = fields_.shape[0] * 56
        return (io + sum(touched.values())) / HBM_BYTES_PER_S * 1e3, io, touched

    bound_ms, io_a, touched_a = bound(ct, fields, words)
    bound_b_ms, io_b, touched_b = bound(ct_b, fields_b, words_b)
    for label, ms, bms, io, touched, ct_, n in (
        (label_a, k3_ms, bound_ms, io_a, touched_a, ct, B),
        (label_b, k3_b_ms, bound_b_ms, io_b, touched_b, ct_b, fields_b.shape[0]),
    ):
        tb = sum(t.numel() * t.element_size() for t in ct_[:5])
        key = "A" if ct_ is ct else "B"
        log(f"{tag} K3 ctrie_walk [{label}]: {ms:.4f} ms at B={n} ({n / ms / 1e3:.1f} M packets/s); "
            f"depth-sorted batch {k3_sorted_ms[key]:.4f} ms ({k3_sorted_ms[key] / ms:.3f}x)")
        log(f"{tag} K3 bound [{label}]: {bms:.4f} ms by bytes = ({io / 1e6:.1f} MB in/out + "
            f"{sum(touched.values()) / 1e6:.1f} MB of the {tb / 1e6:.1f} MB of tables touched, "
            f"in MB: {footprint_text(touched)}) / 3.35 TB/s; K3 is {ms / bms:.1f}x its bound")
    hot = k3_footprint(cwalk, torchpath, ct, fields_hot[:ORACLE_PACKETS],
                       words_hot[:ORACLE_PACKETS])
    log(f"{tag} K3 L2 probe [{label_a}]: {B} packets repeating the first {ORACLE_PACKETS} "
        f"(tables touched {sum(hot.values()) / 1e6:.3f} MB: {footprint_text(hot)}) "
        f"{k3_hot_ms:.4f} ms, against {k3_ms:.4f} ms for {B} distinct packets "
        f"({sum(touched_a.values()) / 1e6:.1f} MB touched)")
    log(f"{tag} K3 plain version: {plain_ms:.4f} ms [table A], {plain_b_ms:.4f} ms [table B]")
    # the fused entry's bound: the narrow wire and the results, the rows
    # the looked-up lanes' walks touch, the statistics
    fused_k3 = {}
    for key, ct_, label in (("A", ct, label_a), ("B", ct_b, label_b)):
        w = wires[key][6][0]
        f_, w_, mask = looked_up_operands(torchpath, w)
        touched = k3_footprint(cwalk, torchpath, ct_, f_[mask].contiguous(),
                               w_[mask].contiguous())
        fbound, fio = fused_bound(w, None, touched)
        fplain = cuda_ms(lambda w=w, ct_=ct_: cwalk.classify_ctrie_wire_fused_plain(ct_, w),
                         reps=1, warmup=0)
        fused_k3[key] = {"ms": turns[key]["fused_ms"], "bound_ms": fbound, "plain_ms": fplain,
                         "composed_ms": turns[key]["composed_ms"], "ops": turns[key]["ops"]}
        log(f"{tag} fused K3 ctrie_wire_fused [{label}, narrow wire]: "
            f"{turns[key]['fused_ms']:.4f} ms at B={w.shape[0]}; bound {fbound:.4f} ms by bytes = "
            f"({fio / 1e6:.2f} MB wire + results + statistics + {sum(touched.values()) / 1e6:.1f} "
            f"MB of tables touched by {int(mask.sum().item())} looked-up lanes, in MB: "
            f"{footprint_text(touched)}) / 3.35 TB/s ({turns[key]['fused_ms'] / fbound:.1f}x); "
            f"plain version {fplain:.4f} ms; the two-column K3 on the same packets "
            f"{k3_ms if key == 'A' else k3_b_ms:.4f} ms")
    log(f"{tag} ctrie device pass (fused K3, table A): {fused_ms:.4f} ms")
    log(f"{tag} ctrie end-to-end classify: {e2e_s * 1e3:.2f} ms per {B} packets (median of 5) = "
        f"{B / e2e_s / 1e6:.3f} M packets/s")
    log(f"{tag} ctrie stages of one classify (host clock, ms): "
        + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in stages.items()))
    return {
        "name": "ctrie_wire_fused",
        "route": "cuda",
        "source": "infw_torch/kernels/csrc/ctrie_walk.cu",
        "replaces": "infw/kernels/pallas_walk.py:918",
        "launches": launches["ctrie_wire_fused"],
        "mismatches": 0,
        "max_abs_err": fused_err,
        "ms": fused_k3["A"]["ms"],
        "plain_ms": fused_k3["A"]["plain_ms"],
        "bound_ms": fused_k3["A"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "table_b": fused_k3["B"],
        "composed_pass_ms": fused_k3["A"]["composed_ms"],
        "device_ops": fused_k3["A"]["ops"],
        "two_column": {
            "name": "ctrie_walk",
            "launches": launches["ctrie_walk"],
            "max_abs_err": err,
            "ms": k3_ms,
            "ms_table_b": k3_b_ms,
            "ms_first_4096_repeated": k3_hot_ms,
            "ms_depth_sorted": k3_sorted_ms["A"],
            "ms_depth_sorted_table_b": k3_sorted_ms["B"],
            "depth": {k: v for k, v in k3_depth["A"].items() if k != "hist"},
            "depth_table_b": {k: v for k, v in k3_depth["B"].items() if k != "hist"},
            "parent_in_turns": k3_parent,
            "plain_ms": plain_ms,
            "plain_ms_table_b": plain_b_ms,
            "bound_ms": bound_ms,
            "bound_ms_table_b": bound_b_ms,
        },
    }, tables, batch, hashed


def compare_k4(wire_decode) -> int:
    """K4 against its plain version on the card, exact, at every width and
    size the codec phase names, from an aligned and an odd byte offset, on
    seeded random bytes; returns the largest absolute difference."""
    import torch

    rng = np.random.default_rng(44)
    err, checked = 0, 0
    for w in (1, 2, 4):
        for n in K4_SIZES:
            buf = torch.from_numpy(rng.integers(0, 256, n * w + 1, dtype=np.uint8)).to("cuda")
            for off in (0, 1):
                c = buf[off:off + n * w]
                got = wire_decode.decode_scan(c, n, w)
                want = wire_decode.decode_scan_plain(c, n, w)
                torch.cuda.synchronize()
                mism = int((got != want).sum().item())
                err = max(err, int((got.long() - want.long()).abs().max().item()))
                checked += 1
                if mism:
                    raise SystemExit(f"K4 disagrees with its plain version at w={w} n={n} "
                                     f"offset {off}: {mism} values")
        total = int(wire_decode._decode_fixed_deltas(buf[:K4_SIZES[-1] * w], K4_SIZES[-1], w)
                    .sum().item())
        log(f"K4 vs plain [w={w}]: n in {K4_SIZES}, byte offsets 0 and 1: 0 mismatching values, "
            f"max_abs_err={err}; the {K4_SIZES[-1]}-value sum is {total} "
            f"({'wraps' if total >= 2**32 else 'does not wrap'} past 2^32)")
    log(f"K4 vs plain: {checked} comparisons, all equal")
    return err


def k4_timings(tag: str, wire_decode) -> dict:
    """K4 at 2^20 values per width from an odd byte offset: CUDA-event time
    per call, profiler device time (which must list one launch of one
    kernel; also at 4096 values, one block), host time per call (no
    synchronize), its bound, the plain version, and torch.cumsum of the
    combined deltas (the prefix sum alone) on the same three clocks.
    {width: numbers}."""
    import torch

    rng = np.random.default_rng(46)
    n = K4_SIZES[-2]
    k4 = {}
    for w in (1, 2, 4):
        c = torch.from_numpy(rng.integers(0, 256, n * w + 1, dtype=np.uint8)).to("cuda")[1:]
        deltas = wire_decode._decode_fixed_deltas(c, n, w)
        k4_fn = lambda: wire_decode.decode_scan(c, n, w)
        cumsum_fn = lambda: torch.cumsum(deltas, 0)
        per_call = {}
        device_us = profiled_kernels(k4_fn, reps=20, counts=per_call)
        if list(per_call.values()) != [1.0]:
            raise SystemExit(f"K4 [w={w}]: the profiler shows kernels per call {per_call}, "
                             "expected one launch of one kernel")
        cumsum_us = profiled_kernels(cumsum_fn, reps=20)
        # one block's worth of values: the launch and its phases without the bytes
        one_block_us = profiled_kernels(lambda: wire_decode.decode_scan(c, 4096, w), reps=20)
        k4[w] = {
            "ms": cuda_ms(k4_fn, reps=50),
            "device_ms": sum(device_us.values()) / 1e3,
            "one_block_device_ms": sum(one_block_us.values()) / 1e3 if one_block_us else None,
            "host_ms": host_ms_per_call(k4_fn),
            "plain_ms": cuda_ms(lambda: wire_decode.decode_scan_plain(c, n, w), reps=20),
            "library_ms": cuda_ms(cumsum_fn, reps=50),
            "library_device_ms": sum(cumsum_us.values()) / 1e3 if cumsum_us else None,
            "library_host_ms": host_ms_per_call(cumsum_fn),
            "bound_ms": n * (w + 4) / HBM_BYTES_PER_S * 1e3,
        }
        t = k4[w]
        log(f"{tag} K4 wire_decode [w={w}, n={n}]: {t['ms']:.4f} ms; bound "
            f"{t['bound_ms']:.4f} ms by bytes ({n * (w + 4)} bytes / 3.35 TB/s), "
            f"{t['ms'] / t['bound_ms']:.1f}x it; plain version {t['plain_ms']:.4f} ms; "
            f"torch.cumsum of the int64 deltas {t['library_ms']:.4f} ms; profiler device "
            f"time per call (us): " + ", ".join(f"{k[:40]} {v:.2f}" for k, v in device_us.items())
            + "; at n=4096 (one block) " + (f"{t['one_block_device_ms'] * 1e3:.2f} us"
                                             if one_block_us else "not measured"))
        log(f"{tag} K4 host time per call [w={w}] (1000 calls, no synchronize): "
            f"{t['host_ms'] * 1e3:.2f} us; torch.cumsum {t['library_host_ms'] * 1e3:.2f} us, "
            f"its profiler device time per call (us): "
            + (", ".join(f"{k[:40]} {v:.2f}" for k, v in cumsum_us.items())
               or "not measured (no device events in the trace)"))
    return k4


def codec_phase(tag: str, cells) -> dict:
    """The wire codecs (delta + K4, wire8) on the IPv4-compact chunk of each
    path's batch: ``cells`` are (path, label, tables, batch, oracle) for the
    trie phase's 100K table (K2) and the ctrie phase's table A (K3).
    Returns K4's kernels-line entry."""
    import torch

    from infw_torch import testing
    from infw_torch.backend.base import stats_from_results
    from infw_torch.backend.cuda import TorchClassifier
    from infw_torch.kernels import all_kernels, cwalk, torchpath, walk, wire_decode
    from infw_torch.layout import v4_trie_depth
    from infw_torch.packets import encode_delta_wire, narrow_wire, wire8

    # 1. K4 against its plain version
    err = compare_k4(wire_decode)
    kernels = all_kernels()
    k4_launches = 0
    timings = {}
    for path, label, tables, batch, reference in cells:
        # the walk a chunk launches: K2 on the trie path; on the ctrie path
        # K3's fused entry for wire8, its two-column entry behind K4 for delta
        walker = "ctrie_walk" if path == "ctrie" else "trie_walk"
        wire8_walker = "ctrie_wire_fused" if path == "ctrie" else "trie_walk"
        idx = np.nonzero((batch.kind != 2) & ~batch.ip_words[:, 1:].any(axis=1))[0]
        sub = batch.take(idx)
        wire, v4_only = batch.pack_wire_subset(idx)
        if wire.shape[1] != 4 or not v4_only:
            raise SystemExit(f"{label}: the IPv4-compact chunk did not pack to 4 words")
        # the references: the mixed batch through classify (narrow wire,
        # device statistics), the same packets as a 7-word packed chunk
        # (narrow wire, device statistics), the oracle
        ref_clf = TorchClassifier(force_path=path)
        ref_clf.load_tables(tables)
        mixed = ref_clf.classify(batch, apply_stats=False)
        narrow = ref_clf.classify_async_packed(sub.pack_wire(), True, apply_stats=False).result()
        if set(ref_clf.wire_stats()) - {"wire6", "wire7"}:
            raise SystemExit(f"{label}: the reference classify shipped {ref_clf.wire_stats()}")
        if not (np.array_equal(narrow.results, mixed.results[idx])
                and np.array_equal(narrow.xdp, mixed.xdp[idx])):
            raise SystemExit(f"{label}: the narrow-wire references disagree")
        head = idx[:ORACLE_PACKETS]
        ref_head = reference(batch.take(head))
        log(f"codec main path [{path}, {label}]: IPv4-compact chunk of {len(idx)} packets "
            f"({len(idx) / len(batch):.1%} of the batch)")

        # 2. the main path, once per codec
        for codec in ("auto", "wire8", "delta"):
            clf = TorchClassifier(force_path=path, wire_codec=codec)
            clf.load_tables(tables)
            for k in kernels:
                k.launches = 0
            t0 = time.perf_counter()
            out = clf.classify_async_packed(wire, v4_only).result()
            first_s = time.perf_counter() - t0
            launches = {k.name: k.launches for k in kernels}
            ws = clf.wire_stats()
            (fmt, (pkts, nbytes)), = ws.items()
            log(f"codec main path [{path}, codec={codec}]: shipped {fmt}, {pkts} packets, "
                f"{nbytes} bytes = {nbytes / pkts:.3f} B/packet; first call {first_s:.3f} s; "
                f"launches {launches}")
            want_k4 = 1 if fmt == "delta" else 0
            if (fmt not in ("delta", "wire8") or pkts != len(idx)
                    or (codec != "auto" and fmt != codec)):
                raise SystemExit(f"{path} codec={codec}: shipped {ws}")
            if launches["wire_decode"] != want_k4 or launches[
                    walker if fmt == "delta" else wire8_walker] != 1 or sum(
                    launches.values()) != 1 + want_k4:
                raise SystemExit(f"{path} codec={codec}: launches {launches}")
            k4_launches += launches["wire_decode"]
            if not (np.array_equal(out.results, mixed.results[idx])
                    and np.array_equal(out.xdp, mixed.xdp[idx])
                    and np.array_equal(out.results, narrow.results)
                    and np.array_equal(out.stats_delta, narrow.stats_delta)):
                raise SystemExit(f"{path} codec={codec}: disagrees with the narrow-wire classify")
            check_recount(sub, out.results, out.stats_delta, f"{path} codec={codec}")
            if not (np.array_equal(out.results[:len(head)], ref_head.results)
                    and np.array_equal(out.xdp[:len(head)], ref_head.xdp)):
                raise SystemExit(f"{path} codec={codec}: the chunk disagrees with the oracle")
            again = clf.classify_async_packed(batch.pack_wire_subset(head)[0], True,
                                              apply_stats=False).result()
            if not (np.array_equal(again.results, ref_head.results)
                    and np.array_equal(again.xdp, ref_head.xdp)
                    and testing.stats_dict_from_array(again.stats_delta) == ref_head.stats):
                raise SystemExit(f"{path} codec={codec}: a {len(head)}-packet chunk disagrees "
                                 "with the oracle")
            hist = np.bincount(out.xdp, minlength=3)
            log(f"codec main path [{path}, codec={codec}]: equal to the mixed classify and the "
                f"7-word packed classify (results, verdicts, statistics), the host recount, and "
                f"the oracle on the chunk's first {len(head)} packets and on them as a chunk "
                f"({again.results.shape[0]} packets, {clf.wire_stats()}); drop={hist[1]} "
                f"pass={hist[2]} rule hits={int((out.results != 0).sum())}")

        # 3. the fixed-stride plans, on clustered addresses near 0.0.0.0
        rng = np.random.default_rng(45)
        for want_w, hi in ((1, 200), (2, 60000)):
            chunk = batch.take(idx[:FIXED_PACKETS])
            chunk.ip_words[:, 0] = rng.permutation(
                np.cumsum(rng.integers(0, hi, FIXED_PACKETS))).astype(np.uint32)
            w4 = chunk.pack_wire_v4()
            enc = encode_delta_wire(w4)
            if enc is None or enc.fixed_w != want_w:
                raise SystemExit(f"{path}: the clustered chunk took fixed_w "
                                 f"{None if enc is None else enc.fixed_w}, not {want_w}")
            clf = TorchClassifier(force_path=path, wire_codec="delta")
            clf.load_tables(tables)
            for k in kernels:
                k.launches = 0
            out = clf.classify_async_packed(w4, True).result()
            launches = {k.name: k.launches for k in kernels}
            if launches["wire_decode"] != 1 or launches[walker] != 1:
                raise SystemExit(f"{path} fixed_w={want_w}: launches {launches}")
            k4_launches += 1
            ref = reference(chunk)
            if not (np.array_equal(out.results, ref.results) and np.array_equal(out.xdp, ref.xdp)
                    and testing.stats_dict_from_array(out.stats_delta) == ref.stats):
                raise SystemExit(f"{path} fixed_w={want_w}: disagrees with the oracle")
            log(f"codec fixed plan [{path}, fixed_w={want_w}, dict_mode {enc.dict_mode}]: "
                f"{FIXED_PACKETS} packets, {enc.wire_bytes / FIXED_PACKETS:.3f} B/packet, "
                f"equal to the oracle; rule hits={int((out.results != 0).sum())}; "
                f"launches {launches}")

        # 4. the stages of one classify per format on this chunk
        n = len(idx)
        if path == "ctrie":
            dev = cwalk.build_ctrie_tables(tables, "cuda", pad=True)
            narrow_pass = lambda wd: cwalk.classify_ctrie_wire_fused(dev, wd)
            wire8_pass = lambda wd, im: cwalk.classify_ctrie_wire8(dev, wd, im)
            delta_entry = wire_decode.classify_delta_ctrie
        else:
            dev = walk.build_trie_tables(tables, "cuda", pad=True)
            depth = v4_trie_depth(dev.n_levels)
            narrow_pass = lambda wd: walk.classify_walk_wire_fused(dev, wd, depth)
            wire8_pass = lambda wd, im: walk.classify_wire8(dev, wd, im)
            delta_entry = wire_decode.classify_delta
        pkt_len = sub.pkt_len.astype(np.int64)
        put = lambda a: torch.from_numpy(a if a.dtype == np.uint8 else a.view(np.int32)).to("cuda")
        for fmt in ("narrow", "wire8", "delta"):
            st = {}
            if fmt == "narrow":
                w3 = timed_stage(st, "host pack", lambda: narrow_wire(wire))
                dargs = timed_stage(st, "H2D", lambda: (put(w3),))
                h2d_bytes = w3.nbytes
                run = lambda: narrow_pass(*dargs)
            elif fmt == "wire8":
                w8, ifmap = timed_stage(st, "host pack", lambda: wire8(wire))
                dargs = timed_stage(st, "H2D", lambda: (put(w8), put(ifmap)))
                h2d_bytes = w8.nbytes + ifmap.nbytes
                run = lambda: wire8_pass(*dargs)
            else:
                enc = timed_stage(st, "host pack", lambda: encode_delta_wire(wire))
                pay = wire_decode.pad_payload(enc.payload)
                dv = wire_decode.pad_dict(enc.dict_vals)
                dargs = timed_stage(st, "H2D", lambda: (put(pay), put(dv), put(enc.ifmap)))
                h2d_bytes = pay.nbytes + dv.nbytes + enc.ifmap.nbytes
                run = lambda: delta_entry(dev, *dargs, n=n, dict_mode=enc.dict_mode,
                                          fixed_w=enc.fixed_w)
            fused = timed_stage(st, "device pass", run)
            host = timed_stage(st, "D2H", lambda: fused.cpu().numpy())

            def finalize():
                if fmt == "narrow":
                    res16, stats = torchpath.split_wire_outputs(host, n)
                    torchpath.merge_stats_host(stats)
                    return torchpath.host_finalize_wire(res16, sub.kind)
                res16 = torchpath.unpack_res16_host(host, n)
                if fmt == "delta":
                    unsorted = np.empty(n, np.uint16)
                    unsorted[enc.perm] = res16
                    res16 = unsorted
                results, xdp = torchpath.host_finalize_wire(res16, sub.kind)
                stats_from_results(results, pkt_len)
                return results, xdp

            results, _ = timed_stage(st, "host finalize", finalize)
            if not np.array_equal(results, narrow.results):
                raise SystemExit(f"{path} {fmt}: the staged classify disagrees")
            dev_ms = cuda_ms(run, reps=10)
            if fmt == "delta":
                decode_ms = cuda_ms(lambda: wire_decode.decode_delta(
                    *dargs, n=n, dict_mode=enc.dict_mode, fixed_w=enc.fixed_w), reps=10)
                top = sorted(profiled_kernels(run, reps=5).items(), key=lambda kv: -kv[1])
                log(f"{tag} codec delta device pass [{path}]: decode alone {decode_ms:.4f} ms "
                    f"(CUDA events); profiler, device us per pass, {len(top)} kernels, total "
                    f"{sum(v for _, v in top):.1f}: "
                    + ("; ".join(f"{k[:60]} {v:.1f}" for k, v in top[:6]) or "not measured"))
            if fmt == "narrow":
                e2e = None
            else:
                clf = TorchClassifier(force_path=path, wire_codec=fmt)
                clf.load_tables(tables)
                e2e = median_s(lambda: clf.classify_async_packed(wire, True, apply_stats=False)
                               .result())
            timings[f"{path} {fmt}"] = {"h2d_bytes": h2d_bytes, "device_ms": dev_ms, "e2e_s": e2e}
            log(f"{tag} codec stages [{path}, {fmt}, {n} packets]: H2D {h2d_bytes} bytes = "
                f"{h2d_bytes / n:.3f} B/packet; device pass {dev_ms:.4f} ms (CUDA events); "
                f"host clock, ms: " + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in st.items())
                + ("" if e2e is None else f"; end to end {e2e * 1e3:.2f} ms (median of 5) = "
                   f"{n / e2e / 1e6:.3f} M packets/s"))

    # 5. K4 times at 2^20 values per width
    k4 = k4_timings(tag, wire_decode)
    return {
        "name": "wire_decode",
        "route": "cuda",
        "source": "infw_torch/kernels/csrc/wire_decode.cu",
        "replaces": "infw/kernels/wire_decode.py:222",
        "launches": k4_launches,
        "mismatches": 0,
        "max_abs_err": err,
        "ms": k4[4]["ms"],
        "device_ms": k4[4]["device_ms"],
        "host_ms": k4[4]["host_ms"],
        "plain_ms": k4[4]["plain_ms"],
        "bound_ms": k4[4]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k4[4]["library_ms"],
        "library_device_ms": k4[4]["library_device_ms"],
        "library_host_ms": k4[4]["library_host_ms"],
        "by_width": {str(w): v for w, v in k4.items()},
        "codec_stages": timings,
    }


def k3b_footprint(arena_walk, torchpath, pool, fields, words, tenant, pages: int,
                  d_max: int) -> dict:
    """The bytes of the arena pool that K3b must read for this batch, each
    row once however many packets share it: the page-table entries, root-LUT
    entries, DIR-16 slots, node rows and target entries the plain walk
    reads, and the joined rows of the matched entries.  The plain walk reads
    every lane, so lanes without a valid tenant or with an ifindex outside
    the LUT add the clamped rows they never use (a few KB)."""
    import torch

    rec = pool._replace(page_table=TableReads(pool.page_table), root_lut=TableReads(pool.root_lut),
                        l0=TableReads(pool.l0), nodes=TableReads(pool.nodes),
                        targets=TableReads(pool.targets))
    sel = torch.cat([
        arena_walk.arena_ctrie_walk_rows(rec, torchpath.batch_from_fields(
            fields[s:s + arena_walk.PLAIN_CHUNK], words[s:s + arena_walk.PLAIN_CHUNK]),
            tenant[s:s + arena_walk.PLAIN_CHUNK], pages, d_max)[1]
        for s in range(0, fields.shape[0], arena_walk.PLAIN_CHUNK)])
    matched = torch.unique(sel[(sel > 0) & (sel < pool.joined.shape[0])]).numel()
    return {
        "page table": rec.page_table.bytes_read(), "root LUT": rec.root_lut.bytes_read(),
        "DIR-16 slots": rec.l0.bytes_read(), "node rows": rec.nodes.bytes_read(),
        "targets": rec.targets.bytes_read(), "joined rows": matched * pool.joined.shape[1] * 2,
    }


def padded_table_bytes(layout, arena, tables) -> int:
    """Device bytes of one tenant's table uploaded alone with the JAX
    package's bucket padding (jaxpath.device_ctrie(pad=True)): the bench's
    per-tenant yardstick for the arena's pool."""
    l0, nodes, targets, _d = layout.build_cpoptrie(tables)
    joined = layout.joined_by_tidx(tables)
    rb = arena._row_bucket
    return (l0.size * 4 + rb(nodes.shape[0]) * 80 + rb(targets.shape[0]) * 4
            + rb(joined.shape[0]) * joined.shape[1] * 2 + rb(len(tables.root_lut)) * 4)


def gpu_memory_used() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used,memory.total", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0].strip()


def arena_phase(tag: str) -> dict:
    """The multi-tenant ctrie arena at the JAX package's tenant bench
    (bench.py bench_tenant): 512 tenants x 64 entries on a 2^20-packet
    mixed batch (K3b against its plain version, the main path, the
    oracles, timings), then the hot-swap pair at SWAP_ENTRIES.  Returns K3b's
    kernels-line entry."""
    import torch

    from infw_torch import arena, layout, oracle, testing
    from infw_torch.backend.cuda import TorchArenaClassifier
    from infw_torch.kernels import all_kernels, arena_walk, cwalk, torchpath
    from infw_torch.packets import concat, narrow_wire

    # 1. the 512-tenant arena (bench.py:2229-2245), every tenant loaded
    # through the classifier; one more tenant is loaded and destroyed
    t0 = time.perf_counter()
    tabs = [testing.random_tables_fast(np.random.default_rng(9000 + t), n_entries=ARENA_ENTRIES,
                                       width=4, v6_fraction=0.3, ifindexes=(2, 3))
            for t in range(ARENA_TENANTS + 1)]
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    spec = arena.arena_spec_for("ctrie", tabs[:ARENA_TENANTS], pages=ARENA_TENANTS + 2,
                                max_tenants=ARENA_TENANTS + 1)
    spec_s = time.perf_counter() - t0
    clf = TorchArenaClassifier(spec)
    t0 = time.perf_counter()
    paths = [clf.load_tenant(t, tab) for t, tab in enumerate(tabs)]
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    gone = ARENA_TENANTS  # the destroyed tenant
    clf.destroy_tenant(gone)
    if set(paths) != {"assign"}:
        raise SystemExit(f"arena loads took paths {sorted(set(paths))}")
    pool = clf.allocator.arena
    log(f"arena spec: {spec}")
    log(f"arena pool bytes by array (MB): " + ", ".join(
        f"{f} {getattr(pool, f).numel() * getattr(pool, f).element_size() / 1e6:.3f}"
        for f in arena.CtrieArena._fields)
        + f"; total {clf.allocator.pool_bytes() / 1e6:.1f} MB; nvidia-smi memory used, total: "
        f"{gpu_memory_used()}")
    log(f"arena build (host clock, s): {len(tabs)} tables {build_s:.2f}, arena_spec_for "
        f"{spec_s:.2f}, {len(tabs)} loads {load_s:.2f}; tenants {len(clf.tenant_ids())}, free "
        f"pages {clf.allocator.free_pages()}")

    # the traffic: 2048 packets per tenant (bench.py:2247-2255 at this
    # size), then 4096 packets with tenant ids -1 and 513, then the
    # destroyed tenant's 2048
    parts = [testing.random_batch_fast(np.random.default_rng(100 + t), tab, ARENA_PER_TENANT)
             for t, tab in enumerate(tabs)]
    odd = testing.random_batch_fast(np.random.default_rng(99), tabs[0], 4096)
    batch = concat(parts[:ARENA_TENANTS] + [odd, parts[gone]])
    main_b = ARENA_TENANTS * ARENA_PER_TENANT
    tenant = np.concatenate([
        np.repeat(np.arange(ARENA_TENANTS, dtype=np.int32), ARENA_PER_TENANT),
        np.repeat(np.array([-1, ARENA_TENANTS + 1], np.int32), 2048),
        np.full(ARENA_PER_TENANT, gone, np.int32)])
    off = np.arange(len(batch)) >= main_b
    wire = batch.pack_wire()
    B = len(batch)

    # 2. K3b against its plain version on every packet
    fields, words = torchpath.packet_fields(torchpath.device_batch(batch, "cuda"))
    tt = torch.from_numpy(tenant).to("cuda")
    kw = {"pages": spec.pages, "d_max": spec.d_max}
    got = arena_walk.arena_ctrie_walk_classify(fields, words, tt, pool, **kw)
    want = arena_walk.arena_ctrie_walk_classify_plain(fields, words, tt, pool, **kw)
    torch.cuda.synchronize()
    mism = int((got != want).any(dim=1).sum().item())
    err = int((got.long() - want.long()).abs().max().item())
    log(f"K3b vs plain [{ARENA_TENANTS} tenants]: B={B} mismatching packets={mism} "
        f"max_abs_err={err} lpm-matched={int((got[:, 1] >= 0).sum().item())}")
    if mism:
        raise SystemExit("K3b disagrees with its plain version on the mixed batch")
    # K3b's fused entry against its plain version on every width
    wires = fused_wires(batch, tenant)
    fused_err = 0
    for width, (w, _m, tw, _idx) in wires.items():
        fused_err = max(fused_err, check_fused(
            f"fused K3b [{ARENA_TENANTS} tenants, width {width}]",
            lambda w=w, tw=tw: arena_walk.classify_arena_wire_fused(pool, w, tw, **kw),
            lambda w=w, tw=tw: arena_walk.classify_arena_wire_fused_plain(pool, w, tw, **kw),
            w.shape[0]))

    # 3. the main path: one mixed classify launches K3b's fused entry once
    # and nothing else
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    out = clf.classify_async_packed_tenant(wire, tenant).result()
    main_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    log(f"arena main path: classify_async_packed_tenant({B}) in {main_s:.3f} s (first call), "
        f"launches {launches}; wire_stats {clf.wire_stats()}")
    if launches["arena_wire_fused"] != 1 or sum(launches.values()) != 1:
        raise SystemExit("the arena main path must launch arena_wire_fused once and nothing else")
    check_recount(batch, out.results, out.stats_delta, "arena main path")
    if out.results[off].any() or not np.array_equal(out.xdp[off],
                                                    np.where(batch.kind[off] == 0, 1, 2)):
        raise SystemExit("lanes of invalid or destroyed tenants are not UNDEF")
    log(f"arena main path: the {int(off.sum())} lanes of tenants -1, {ARENA_TENANTS + 1} and the "
        f"destroyed {gone} are all UNDEF")
    # the per-tenant oracles on 8 packets per tenant (the JAX bench's 4096)
    idx = (np.arange(ARENA_TENANTS)[:, None] * ARENA_PER_TENANT + np.arange(8)[None, :]).ravel()
    sub = batch.take(idx)
    again = clf.classify_async_packed_tenant(sub.pack_wire(), tenant[idx],
                                             apply_stats=False).result()
    ref_results = np.zeros(len(idx), np.uint32)
    ref_xdp = np.zeros(len(idx), np.int32)
    ref_stats = {}
    for t in range(ARENA_TENANTS):
        r = oracle.classify(tabs[t], sub.slice(8 * t, 8 * t + 8))
        ref_results[8 * t:8 * t + 8], ref_xdp[8 * t:8 * t + 8] = r.results, r.xdp
        for rid, v in r.stats.items():
            acc = ref_stats.setdefault(rid, [0, 0, 0, 0])
            for j in range(4):
                acc[j] += v[j]
    ok = (np.array_equal(out.results[idx], ref_results) and np.array_equal(out.xdp[idx], ref_xdp)
          and np.array_equal(again.results, ref_results) and np.array_equal(again.xdp, ref_xdp)
          and testing.stats_dict_from_array(again.stats_delta) == ref_stats)
    log(f"arena main path vs per-tenant oracles [8 packets x {ARENA_TENANTS} tenants]: "
        f"{'equal' if ok else 'DIFFERENT'} (in the mixed run and classified again, statistics "
        f"included)")
    if not ok:
        raise SystemExit("the arena main path disagrees with the per-tenant oracles")
    hist = np.bincount(out.xdp, minlength=3)
    log(f"arena main path verdicts: drop={hist[1]} pass={hist[2]} "
        f"rule hits={int((out.results != 0).sum())}")
    # tenant ids outside int32 must not wrap onto a served tenant: tenant
    # 1's own packets under ids 2^32 + 1 and -2^32 + 1 are UNDEF, uncounted
    sub1 = parts[1].slice(0, ORACLE_PACKETS)
    before = clf.tenant_counters()
    for bad in (2**32 + 1, -(2**32) + 1):
        o = clf.classify_async_packed_tenant(sub1.pack_wire(),
                                             np.full(len(sub1), bad, np.int64)).result()
        if (o.results.any() or o.stats_delta.any()
                or not np.array_equal(o.xdp, np.where(sub1.kind == 0, 1, 2))):
            raise SystemExit(f"tenant id {bad} is not UNDEF")
    if clf.tenant_counters() != before:
        raise SystemExit("out-of-range tenant ids were counted")
    log(f"arena: tenant 1's first {len(sub1)} packets under tenant ids 2^32 + 1 and -2^32 + 1 "
        "are all UNDEF and counted nowhere")

    # 4. timings: K3b, its plain version, its bound, end to end against
    # sequential per-tenant dispatch, the stage split, the footprint
    k3b_ms = cuda_ms(lambda: arena_walk.arena_ctrie_walk_classify(fields, words, tt, pool, **kw),
                     reps=20)
    k3b_parent = parent_turns(
        tag, f"K3b, {ARENA_TENANTS} tenants",
        lambda: arena_walk.arena_ctrie_walk_classify(fields, words, tt, pool, **kw),
        parent_run("arena_ctrie_walk",
                   lambda: arena_walk.kernel_args(fields, words, tt, pool, **kw)),
    ) if PARENT_KERNELS else None
    device_us = profiled_kernels(
        lambda: arena_walk.arena_ctrie_walk_classify(fields, words, tt, pool, **kw), reps=10)
    plain_ms = cuda_ms(lambda: arena_walk.arena_ctrie_walk_classify_plain(
        fields, words, tt, pool, **kw), reps=3, warmup=1)
    touched = k3b_footprint(arena_walk, torchpath, pool, fields, words, tt, **kw)
    io = B * 56
    bound_ms = (io + sum(touched.values())) / HBM_BYTES_PER_S * 1e3
    sub_wires = [(batch.pack_wire_subset(np.arange(t * ARENA_PER_TENANT,
                                                   (t + 1) * ARENA_PER_TENANT))[0],
                  np.full(ARENA_PER_TENANT, t, np.int32)) for t in range(ARENA_TENANTS)]
    main_wire, main_tenant = wire[:main_b], tenant[:main_b]

    def mixed_once():
        t0 = time.perf_counter()
        clf.classify_async_packed_tenant(main_wire, main_tenant, apply_stats=False).result()
        return time.perf_counter() - t0

    def seq_once():
        t0 = time.perf_counter()
        pend = [clf.classify_async_packed_tenant(w, tg, apply_stats=False) for w, tg in sub_wires]
        for p in pend:
            p.result()
        return time.perf_counter() - t0

    mixed_once()
    seq_once()
    mixed_s = seq_s = float("inf")
    for _ in range(3):  # interleaved, min against min (bench.py:2302-2306)
        mixed_s = min(mixed_s, mixed_once())
        seq_s = min(seq_s, seq_once())
    stages = {}
    packed = timed_stage(stages, "wire pack", lambda: batch.slice(0, main_b).pack_wire())
    narrow = timed_stage(stages, "host narrow", lambda: narrow_wire(packed))
    dev = timed_stage(stages, "H2D wire + tenant", lambda: (
        torch.from_numpy(narrow.view(np.int32)).to("cuda"),
        torch.from_numpy(main_tenant).to("cuda")))
    run = lambda: arena_walk.classify_arena_wire_fused(pool, dev[0], dev[1], **kw)
    fused = timed_stage(stages, "device pass", run)
    host = timed_stage(stages, "D2H", lambda: fused.cpu().numpy())

    def host_finalize():
        res16, st = torchpath.split_wire_outputs(host, main_b)
        torchpath.merge_stats_host(st)
        return torchpath.host_finalize_wire(res16, batch.kind[:main_b])

    results, _ = timed_stage(stages, "host finalize", host_finalize)
    timed_stage(stages, "per-tenant counts", lambda: clf._note_tenants(main_tenant, results))
    # the device pass: K3b's fused entry against the composition it
    # replaced, in turns, on the main path's narrow wire; its bound and
    # plain version
    tturns = fused_turns(tag, f"arena, {ARENA_TENANTS} tenants, {main_b} packets, narrow wire",
                         run, lambda: composed_arena(arena_walk, torchpath, pool, dev[0], dev[1],
                                                     **kw))
    fused_ms = tturns["fused_ms"]
    f_, w_, mask = looked_up_operands(torchpath, dev[0])
    ftouched = k3b_footprint(arena_walk, torchpath, pool, f_[mask].contiguous(),
                             w_[mask].contiguous(), dev[1][mask].contiguous(), **kw)
    fbound, fio = fused_bound(dev[0], dev[1], ftouched)
    fplain = cuda_ms(lambda: arena_walk.classify_arena_wire_fused_plain(pool, dev[0], dev[1],
                                                                        **kw), reps=1, warmup=0)
    table_b = sum(padded_table_bytes(layout, arena, t) for t in tabs[:ARENA_TENANTS])
    log(f"{tag} K3b arena_ctrie_walk [{ARENA_TENANTS} tenants, mixed batch]: {k3b_ms:.4f} ms at "
        f"B={B} ({B / k3b_ms / 1e3:.1f} M packets/s); profiler device time per call (us): "
        + (", ".join(f"{k[:40]} {v:.2f}" for k, v in device_us.items())
           or "not measured (no device events in the trace)"))
    log(f"{tag} K3b bound: {bound_ms:.4f} ms by bytes = ({io / 1e6:.1f} MB in/out + "
        f"{sum(touched.values()) / 1e6:.1f} MB of the {clf.allocator.pool_bytes() / 1e6:.1f} MB "
        f"pool touched, in MB: {footprint_text(touched)}) / 3.35 TB/s; K3b is "
        f"{k3b_ms / bound_ms:.1f}x its bound")
    log(f"{tag} K3b plain version: {plain_ms:.4f} ms; library call: none (no PyTorch call "
        f"computes the walk)")
    log(f"{tag} fused K3b arena_wire_fused [{ARENA_TENANTS} tenants, {main_b} packets, narrow "
        f"wire]: {fused_ms:.4f} ms; bound {fbound:.4f} ms by bytes = ({fio / 1e6:.2f} MB wire + "
        f"tenant + results + statistics + {sum(ftouched.values()) / 1e6:.1f} MB of the pool "
        f"touched by {int(mask.sum().item())} looked-up lanes, in MB: {footprint_text(ftouched)}) "
        f"/ 3.35 TB/s ({fused_ms / fbound:.1f}x); plain version {fplain:.4f} ms")
    log(f"{tag} arena device pass (fused K3b, {main_b} packets): {fused_ms:.4f} ms")
    log(f"{tag} arena mixed batch: {mixed_s * 1e3:.2f} ms per {main_b} packets = "
        f"{main_b / mixed_s / 1e6:.3f} M packets/s, against sequential per-tenant dispatch "
        f"({ARENA_TENANTS} calls) {seq_s * 1e3:.2f} ms = {main_b / seq_s / 1e6:.3f} M packets/s "
        f"({seq_s / mixed_s:.1f}x; min of 3, interleaved)")
    log(f"{tag} arena stages of one mixed classify (host clock, ms): "
        + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in stages.items()))
    log(f"{tag} arena footprint: pool {clf.allocator.pool_bytes() / 1e6:.1f} MB against "
        f"{ARENA_TENANTS} padded tables {table_b / 1e6:.1f} MB "
        f"({table_b / clf.allocator.pool_bytes():.3f}x)")
    del pool, fields, words, tt, got, want
    clf.close()

    # 5. the hot-swap pair (bench.py:2188-2225, 1M entries there)
    t0 = time.perf_counter()
    big = testing.clean_tables_fast(np.random.default_rng(2024), SWAP_ENTRIES, width=4)
    big2 = testing.clean_tables_fast(np.random.default_rng(4242), SWAP_ENTRIES, width=4)
    spec2 = arena.arena_spec_for("ctrie", (big, big2), pages=4, max_tenants=8)
    swap_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    oracles = {id(big): ColumnOracle(big), id(big2): ColumnOracle(big2)}
    oracle_s = time.perf_counter() - t0
    rng = np.random.default_rng(2025)
    batches = {id(big): testing.random_batch_fast(rng, big, SWAP_PACKETS),
               id(big2): testing.random_batch_fast(rng, big2, SWAP_PACKETS)}
    sw = TorchArenaClassifier(spec2)
    alloc = sw.allocator
    t0 = time.perf_counter()
    alloc.load_tenant(0, big)
    pg_a = alloc.stage(big2)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    pg_b = alloc.page_of(0)
    log(f"swap pair: 2 x {SWAP_ENTRIES} entries, spec {spec2}; tables + spec {swap_build_s:.2f} s, "
        f"ColumnOracle x2 {oracle_s:.2f} s, load + stage {stage_s:.2f} s; pool "
        f"{alloc.pool_bytes() / 1e6:.1f} MB; nvidia-smi memory used, total: {gpu_memory_used()}")

    def check_active(active, label):
        """Both tables' batches as tenant 0: each must get the active
        table's verdicts (on 4096-packet subsets and the first packets of
        each kind), K3b's fused entry once per classify."""
        ref = oracles[id(active)]
        for name, b in (("its own batch", batches[id(active)]),
                        ("the other table's batch", batches[id(big2 if active is big else big)])):
            before = arena_walk.FUSED_KERNEL.launches
            o = sw.classify_async_packed_tenant(b.pack_wire(), np.zeros(len(b), np.int32)).result()
            if arena_walk.FUSED_KERNEL.launches != before + 1:
                raise SystemExit(f"{label}: K3b's fused entry was not launched once")
            check_recount(b, o.results, o.stats_delta, label)
            subsets = {"first": np.arange(ORACLE_PACKETS)}
            for kind, kname in ((1, "v4"), (2, "v6"), (0, "malformed"), (3, "other")):
                subsets[f"first {kname}"] = np.nonzero(b.kind == kind)[0][:ORACLE_PACKETS]
            for sname, ix in subsets.items():
                r = ref.classify(b.take(ix))
                if not (np.array_equal(o.results[ix], r.results)
                        and np.array_equal(o.xdp[ix], r.xdp)):
                    raise SystemExit(f"{label}: {name} disagrees with the oracle ({sname})")
            log(f"swap {label}: {name} ({len(b)} packets) equal to the active table's oracle on "
                f"{', '.join(f'{k} {len(v)}' for k, v in subsets.items())} packets; rule hits "
                f"{int((o.results != 0).sum())}")

    def flip_once(i):
        t0 = time.perf_counter()
        alloc.activate(0, pg_a if i % 2 == 0 else pg_b)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def upload_once(i):
        t = big2 if i % 2 == 0 else big
        t0 = time.perf_counter()
        cwalk.build_ctrie_tables(t, "cuda", pad=True)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    flip_s = upload_s = float("inf")
    flip_once(0)  # warm both off the clock
    upload_once(0)
    check_active(big2, "after flip 0")
    for i in range(1, 4):  # interleaved min against min
        flip_s = min(flip_s, flip_once(i))
        upload_s = min(upload_s, upload_once(i))
        check_active(big2 if i % 2 == 0 else big, f"after flip {i}")
    log(f"{tag} swap @{SWAP_ENTRIES} entries: page-table flip {flip_s * 1e6:.1f} us against a full "
        f"upload (cwalk.build_ctrie_tables, padded) {upload_s * 1e3:.2f} ms = {upload_s / flip_s:.0f}x "
        f"(min of 3, interleaved, host clock to a synchronize)")
    # the flip again, back to back (the card kept busy), and a synchronize
    # of an idle card alone: what the interleaved reading is made of
    warm_s = min(flip_once(i) for i in range(4, 24))

    def sync_once():
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    sync_s = min(sync_once() for _ in range(20))
    log(f"{tag} swap flip back to back: {warm_s * 1e6:.1f} us (min of 20); a synchronize of an "
        f"idle card alone {sync_s * 1e6:.1f} us (min of 20)")
    # a destroy, then a compaction that moves a live slab
    if sw.load_tenant(1, big2) != "assign":
        raise SystemExit("tenant 1 should take a fresh page")
    sw.destroy_tenant(0)
    page_before = alloc.page_of(1)
    moved = sw.compact()
    log(f"swap compaction: tenant 0 destroyed, tenant 1 moved page {page_before} -> "
        f"{alloc.page_of(1)} ({moved} row moved), free pages {alloc.free_pages()}")
    if moved != 1 or alloc.page_of(1) >= page_before:
        raise SystemExit("compaction did not move the live slab down")
    b = batches[id(big2)]
    o = sw.classify_async_packed_tenant(b.pack_wire(), np.ones(len(b), np.int32)).result()
    r = oracles[id(big2)].classify(b.slice(0, ORACLE_PACKETS))
    gone0 = sw.classify_async_packed_tenant(b.pack_wire()[:ORACLE_PACKETS],
                                            np.zeros(ORACLE_PACKETS, np.int32)).result()
    if not (np.array_equal(o.results[:ORACLE_PACKETS], r.results)
            and np.array_equal(o.xdp[:ORACLE_PACKETS], r.xdp) and not gone0.results.any()):
        raise SystemExit("after the compaction the arena disagrees with the oracle")
    check_recount(b, o.results, o.stats_delta, "after the compaction")
    log(f"swap after the compaction: tenant 1 equal to the oracle on its first {ORACLE_PACKETS} "
        f"packets, the destroyed tenant 0 UNDEF")
    sw.close()
    return {
        "name": "arena_wire_fused",
        "route": "cuda",
        "source": "infw_torch/kernels/csrc/arena_ctrie_walk.cu",
        "replaces": "infw/kernels/pallas_walk.py:1156",
        "launches": launches["arena_wire_fused"],
        "mismatches": 0,
        "max_abs_err": fused_err,
        "ms": fused_ms,
        "plain_ms": fplain,
        "bound_ms": fbound,
        "bound_by": "bytes",
        "library_ms": None,
        "composed_pass_ms": tturns["composed_ms"],
        "device_ops": tturns["ops"],
        "two_column": {
            "name": "arena_ctrie_walk",
            "launches": launches["arena_ctrie_walk"],
            "max_abs_err": err,
            "ms": k3b_ms,
            "parent_in_turns": k3b_parent,
            "device_ms": sum(device_us.values()) / 1e3 if device_us else None,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
        },
        "mixed_packets_per_s": main_b / mixed_s,
        "sequential_packets_per_s": main_b / seq_s,
        "flip_ms": flip_s * 1e3,
        "flip_back_to_back_ms": warm_s * 1e3,
        "upload_ms": upload_s * 1e3,
    }


def churn_keys(rng, n: int, taken: set, compiler, testing, width: int):
    """``n`` new /24 (IPv4) and /48 (IPv6) keys on ifindexes 2, 3, 4 whose
    masked identities are not in ``taken`` (which takes them), with
    random rule rows."""
    out = {}
    while len(out) < n:
        v6 = rng.random() < 0.5
        ip = bytes(rng.integers(0, 256, 6 if v6 else 3, dtype=np.uint8))
        key = compiler.LpmKey(32 + (48 if v6 else 24), int(rng.choice([2, 3, 4])),
                              ip + bytes(16 - len(ip)))
        ident = key.masked_identity()
        if ident not in taken:
            taken.add(ident)
            out[key] = testing.random_rules(rng, width)
    return out


def timed_flush(applier, ops):
    """applier.apply(ops) to the end of its device work: (report, host
    milliseconds, CUDA-event milliseconds)."""
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    rep = applier.apply(ops)
    stop.record()
    torch.cuda.synchronize()
    return rep, (time.perf_counter() - t0) * 1e3, start.elapsed_time(stop)


def flush_operations(fn, windows: int = 3):
    """Flushes (``fn()``) under torch.profiler, in ``windows`` windows of
    two: a warm flush, then the recorded one with 20 ms of margin on each
    side, as profiled_kernels records its calls.  Always 2 * ``windows``
    flushes, so what they apply does not depend on the trace.  Returns (the
    last flush's result, the counts of the first window whose trace holds
    a device event for every kernel launch call, else of the last one):
    host-to-device copies, device-to-device copies, kernels and memsets on
    the device timeline ("lost" when the trace has fewer kernels than
    launch calls), and on the host the runtime's copy, launch and memset
    calls and the aten copies (``_to_copy``: the staged rows in, ``clone``:
    the device clones) per flush."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    best = None
    for _window in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(0.02)
            out = fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
            prof.step()
        dev = {"h2d": 0, "d2d": 0, "kernels": 0, "memsets": 0}
        host = {"cudaMemcpyAsync": 0, "cudaLaunchKernel": 0, "cudaMemsetAsync": 0,
                "aten::_to_copy": 0, "aten::clone": 0, "aten::index_copy_": 0}
        for e in prof.events():
            if e.is_user_annotation or e.name.startswith("ProfilerStep"):
                continue
            if e.device_type == DeviceType.CUDA:
                if e.name.startswith("Memcpy"):
                    kind = "h2d" if "HtoD" in e.name else "d2d" if "DtoD" in e.name else "d2h"
                    dev[kind] = dev.get(kind, 0) + 1
                else:
                    dev["memsets" if e.name.startswith("Memset") else "kernels"] += 1
            elif e.name in host:
                host[e.name] += 1
            elif e.name.startswith(("cudaLaunch", "cuLaunch")):
                host["cudaLaunchKernel"] += 1
        complete = dev["kernels"] >= host["cudaLaunchKernel"]
        if best is None or (complete and not best[0]):
            best = (complete, {"device": dev if complete else "lost", "host": host})
    return out, best[1]


class _Content:
    """What HashLpmOracle reads of a table: its content map."""

    def __init__(self, content):
        self.content = content


def oracle_for(content, batch):
    """oracle.HashLpmOracle over the entries of ``content`` (a {LpmKey:
    rules} map) that ``batch``'s packets can match, picked as ColumnOracle
    picks them, in one pass over the map: exact for every packet of
    ``batch``.  One full oracle of a 1M-entry content map takes about 5 s
    of host time, and the churn phase needs six."""
    from infw_torch import oracle

    ifx = np.asarray(batch.ifindex).astype(np.int64) << 32
    ip0 = np.asarray(batch.ip_words)[:, 0].astype(np.int64)
    wanted, sub = {}, {}
    for k, v in content.items():
        m = min(max(k.prefix_len - 32, 0), 32)
        w = wanted.get(m)
        if w is None:
            mask = ((0xFFFFFFFF << (32 - m)) & 0xFFFFFFFF) if m else 0
            w = wanted[m] = (mask, set((ifx | (ip0 & mask)).tolist()))
        if ((k.ingress_ifindex << 32) | (int.from_bytes(k.ip_data[:4], "big") & w[0])) in w[1]:
            sub[k] = v
    return oracle.HashLpmOracle(_Content(sub))


class ColumnOracle:
    """oracle.HashLpmOracle over only the content entries that can match a
    batch's packets, picked per call from the table's content columns (the
    LazyContent's own source, not the compiled arrays): every entry whose
    ifindex and first address word, masked to the entry's length (at most
    32 bits), equal some packet's.  That keeps every entry a packet's
    longest-prefix match could name, in content order (so the oracle's
    masked-identity dedup is unchanged), and the answer is the full
    oracle's for every packet it is asked about.  A full HashLpmOracle of
    the 10M-entry table takes about 111 s of host time; this reads the
    columns once and each batch in milliseconds."""

    def __init__(self, tables):
        from infw_torch import oracle

        cols = tables.content.columns() if hasattr(tables.content, "columns") else None
        # a built content map may have left the columns stale: the full
        # oracle then
        self._full = oracle.HashLpmOracle(tables) if cols is None else None
        if cols is None:
            return
        self._plen, self._ifx, self._rules = cols.prefix_len, cols.ifindex, cols.rules
        ip = np.asarray(cols.ip, np.uint8)
        self._ip_b = np.ascontiguousarray(ip).tobytes()
        ip0 = ((ip[:, 0].astype(np.uint64) << 24) | (ip[:, 1].astype(np.uint64) << 16)
               | (ip[:, 2].astype(np.uint64) << 8) | ip[:, 3].astype(np.uint64))
        bits = np.clip(np.asarray(self._plen, np.int64) - 32, 0, 32)
        self._groups = []
        for m in np.unique(bits):
            rows = np.nonzero(bits == m)[0]
            word_mask = np.uint64(((0xFFFFFFFF << (32 - int(m))) & 0xFFFFFFFF) if m else 0)
            keys = (np.asarray(self._ifx, np.uint64)[rows] << np.uint64(32)) | (ip0[rows]
                                                                                & word_mask)
            order = np.argsort(keys, kind="stable")
            self._groups.append((word_mask, keys[order], rows[order]))

    def classify(self, batch):
        from infw_torch import oracle
        from infw_torch.compiler import LpmKey

        if self._full is not None:
            return self._full.classify(batch)
        ifx = np.asarray(batch.ifindex).astype(np.uint64) << np.uint64(32)
        ip0 = np.asarray(batch.ip_words)[:, 0].astype(np.uint64)
        picked = []
        for word_mask, keys, rows in self._groups:
            q = np.unique(ifx | (ip0 & word_mask))
            lo, hi = np.searchsorted(keys, q, "left"), np.searchsorted(keys, q, "right")
            picked += [rows[a:b] for a, b in zip(lo, hi) if b > a]
        sel = np.unique(np.concatenate(picked)) if picked else np.zeros(0, np.int64)
        ip_b = self._ip_b
        content = {LpmKey(int(self._plen[t]), int(self._ifx[t]), ip_b[16 * t: 16 * t + 16]):
                   self._rules[t] for t in sel}
        return oracle.HashLpmOracle(_Content(content)).classify(batch)


def churn_phase(tag: str, n_entries: int = CHURN_ENTRIES, n_packets: int = CHURN_PACKETS,
                device: str = "cuda") -> dict:
    """The JAX package's churn tier (bench.py:1899-1938, bench_churn) on
    both layouts, cut to an eighth of its 1M entries: one table of
    random_tables_fast(CHURN_ENTRIES entries, width 4, ifindexes 2, 3, 4) loaded through
    IncrementalTables.from_content into TorchClassifier(force_path=...,
    wire_codec="wire8"), then four steps: one rules-only edit, 64 folded
    rules-only edits, a structural round (4 deletes, 5 adds) and a
    1024-key overlay; then the edit transactions (txn.TxnApplier): one
    64-op transaction of the edit generator's full mix (rules edits, new
    CIDRs to the overlay, deletes, re-adds), bench_churn's A/B (64
    rules-only edits folded into one transaction against 8 one-edit
    generations, per edit, interleaved, the min of 2 rounds) and one folded flush
    under the profiler (its host-to-device copies and kernels).  After each
    step: the resident tables against a fresh padded build, K2/K3 (and K1
    over the overlay) against the plain version, the batch against the
    HashLpmOracle of the merged content and a recount, launch counts, and
    the trie and ctrie layouts against each other.  Returns the timings."""
    import torch

    from infw_torch import compiler, oracle, testing, txn
    from infw_torch.backend.cuda import TorchClassifier
    from infw_torch.kernels import all_kernels, cwalk, dense, overlay, torchpath, walk
    from infw_torch.packets import concat, narrow_wire

    phase_t0 = time.perf_counter()
    oracle_s = 0.0
    t0 = time.perf_counter()
    base = testing.random_tables_fast(np.random.default_rng(1899), n_entries=n_entries,
                                      width=CHURN_WIDTH, ifindexes=(2, 3, 4))
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    taken = {k.masked_identity() for k in base.content}
    # the overlay keys (step 4) are drawn now, so a slice of the batch can
    # aim at them; the structural round's adds come from the edit stream
    ov_content = churn_keys(np.random.default_rng(4243), CHURN_OVERLAY, taken, compiler,
                            testing, CHURN_WIDTH)
    ov = compiler.compile_tables_from_content(ov_content, rule_width=CHURN_WIDTH)
    rng = np.random.default_rng(1900)
    batch = concat([testing.random_batch_fast(rng, base, n_packets - ORACLE_PACKETS),
                    testing.random_batch_fast(rng, ov, ORACLE_PACKETS)])
    batch.ip_words[batch.kind != 2, 1:] = 0  # the IPv4 chunk ships wire8
    v4 = np.nonzero(batch.kind == 1)[0]
    subsets = {"first": np.arange(ORACLE_PACKETS),
               "overlay-aimed": np.arange(len(batch) - ORACLE_PACKETS, len(batch))}
    prep_s = time.perf_counter() - t0
    log(f"churn: {n_entries} entries x {CHURN_WIDTH} rule slots (random_tables_fast, ifindexes "
        f"2, 3, 4) in {gen_s:.2f} s; {CHURN_OVERLAY} overlay keys, {len(batch)}-packet batch "
        f"({len(v4)} IPv4, {ORACLE_PACKETS} aimed at the overlay) in {prep_s:.2f} s")

    oracles = {}  # step -> HashLpmOracle, shared by the two layouts
    by_layout = {}
    timings = {}
    kernels = all_kernels()
    for layout_name in ("trie", "ctrie"):
        t0 = time.perf_counter()
        it = compiler.IncrementalTables.from_content(base.content, rule_width=CHURN_WIDTH)
        clf = TorchClassifier(device=device, force_path=layout_name, wire_codec="wire8")
        clf.load_tables(it.snapshot())
        it.clear_dirty()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if clf.active_path != layout_name:
            raise SystemExit(f"churn[{layout_name}]: the table is served on {clf.active_path}")
        t0 = time.perf_counter()
        keys = list(it.content)  # the first edit builds the content maps
        maps_s = time.perf_counter() - t0
        log(f"churn[{layout_name}]: IncrementalTables.from_content + snapshot + load "
            f"{load_s:.2f} s, content maps {maps_s:.2f} s, {clf._last_load}")
        edit_rng = np.random.default_rng(4242)
        seen = set(taken)  # each layout draws the same adds

        def mk_edits(n):
            # rules-only edits on live keys (bench.py:1927-1938)
            picks = edit_rng.choice(len(keys), size=n, replace=False)
            return {keys[int(i)]: testing.random_rules(edit_rng, CHURN_WIDTH) for i in picks}

        build = cwalk.build_ctrie_tables if layout_name == "ctrie" else walk.build_trie_tables
        main_k = cwalk.KERNEL if layout_name == "ctrie" else walk.KERNEL
        results = []

        def verify(step: str, snap, ov_content):
            """The resident tables against a fresh padded build of ``snap``,
            the walk (and K1 over an overlay) against its plain version,
            the main path (launch counts, recount, the wire8 chunk) and the
            oracle of the merged content; returns (results, launches)."""
            nonlocal oracle_s
            fresh = build(snap, device, pad=True)
            dev = clf._active.dev
            for f in fresh._fields:
                a, b = getattr(dev, f), getattr(fresh, f)
                if not (torch.equal(a, b) if isinstance(b, torch.Tensor) else a == b):
                    raise SystemExit(f"churn[{layout_name}] {step}: resident {f} differs from a "
                                     f"fresh padded build")
            del fresh
            # the kernel against its plain version on the batch
            fields, words = torchpath.packet_fields(torchpath.device_batch(batch, device))
            if layout_name == "ctrie":
                got = cwalk.ctrie_walk_classify(fields, words, dev)
                want = cwalk.ctrie_walk_classify_plain(fields, words, dev)
            else:
                got = walk.trie_walk_classify(fields, words, dev, dev.n_levels)
                want = walk.trie_walk_classify_plain(fields, words, dev, dev.n_levels)
            if not torch.equal(got, want):
                raise SystemExit(f"churn[{layout_name}] {step}: {main_k.name} disagrees with "
                                 f"its plain version")
            ov_dev = clf._active.ov
            if isinstance(ov_dev, dense.DenseTables):
                got = dense.dense_classify(fields, words, ov_dev)
                want = dense.dense_classify_plain(fields, words, ov_dev)
                if not torch.equal(got, want):
                    raise SystemExit(f"churn[{layout_name}] {step}: K1 over the overlay disagrees "
                                     f"with its plain version")
            del got, want, fields, words
            # the main path: the whole batch (narrow wire), then the IPv4
            # chunk (wire8), launch counts zeroed before and read after
            for k in kernels:
                k.launches = 0
            out = clf.classify(batch)
            w4, v4_only = batch.pack_wire_subset(v4)
            out4 = clf.classify_async_packed(w4, v4_only).result()
            launches = {k.name: k.launches for k in kernels if k.launches}
            # without an overlay the ctrie classify is K3's fused entry;
            # the overlay combine reads K3's two-column entry, and K1 over
            # the overlay (K2 over a table K1 cannot hold)
            if ov_dev is None:
                want_k = {("ctrie_wire_fused" if layout_name == "ctrie" else main_k.name): 2}
            else:
                want_k = {main_k.name: 2}
                ov_name = "dense_classify" if isinstance(ov_dev, dense.DenseTables) else "trie_walk"
                want_k[ov_name] = want_k.get(ov_name, 0) + 2
            if launches != want_k:
                raise SystemExit(f"churn[{layout_name}] {step}: launches {launches}, expected "
                                 f"{want_k}")
            check_recount(batch, out.results, out.stats_delta, f"churn[{layout_name}] {step}")
            if not np.array_equal(out4.results, out.results[v4]):
                raise SystemExit(f"churn[{layout_name}] {step}: the wire8 chunk disagrees")
            if step not in oracles:
                content = dict(snap.content)
                content.update(ov_content)
                t0 = time.perf_counter()
                # over the entries the checked subsets can match
                oracles[step] = oracle_for(content, batch.take(np.concatenate(
                    list(subsets.values()))))
                oracle_s += time.perf_counter() - t0
            for name, ix in subsets.items():
                ref = oracles[step].classify(batch.take(ix))
                if not (np.array_equal(out.results[ix], ref.results)
                        and np.array_equal(out.xdp[ix], ref.xdp)):
                    raise SystemExit(f"churn[{layout_name}] {step}: disagrees with the oracle "
                                     f"({name})")
            results.append(out.results)
            return out.results, launches

        steps = (("edit1", "1 rules-only edit"), ("edit64", "64 folded rules-only edits"),
                 ("struct", "structural round (4 deletes, 5 adds)"),
                 ("overlay", f"{CHURN_OVERLAY}-key overlay"))
        for kind, step in steps:
            ov_arg = None
            if kind == "edit1":
                it.apply(mk_edits(1))
            elif kind == "edit64":
                it.apply(mk_edits(64))
            elif kind == "struct":
                dels = [keys[int(i)] for i in edit_rng.choice(len(keys), size=4, replace=False)]
                adds = churn_keys(edit_rng, 5, seen, compiler, testing, CHURN_WIDTH)
                it.apply(adds, deletes=dels)
                gone = set(dels)
                keys = [k for k in keys if k not in gone] + list(adds)
            else:
                ov_arg = ov
            t0 = time.perf_counter()
            snap = it.snapshot()
            hint = it.peek_dirty()
            snap_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            clf.load_tables(snap, dirty_hint=hint, overlay=ov_arg)
            stop.record()
            torch.cuda.synchronize()
            patch_s = time.perf_counter() - t0
            patch_ev = start.elapsed_time(stop)
            it.clear_dirty()
            mode = clf._last_load
            if kind in ("edit1", "edit64") and mode[0] != "patch":
                raise SystemExit(f"churn[{layout_name}] {step}: loaded by {mode}, not a patch")
            # a full upload of the same table through the same entry point,
            # on the host layouts the patch left built (the cold load with
            # the layout build is the first load above)
            full = TorchClassifier(device=device, force_path=layout_name, wire_codec="wire8")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            full.load_tables(snap)
            torch.cuda.synchronize()
            full_s = time.perf_counter() - t0
            cold_s = None
            if kind == "struct":
                # a structural patch builds the edited snapshot's layouts, so
                # it is also held against a cold full load of that snapshot:
                # a copy without its memoized layouts, built and uploaded
                cold = TorchClassifier(device=device, force_path=layout_name, wire_codec="wire8")
                t0 = time.perf_counter()
                cold.load_tables(dataclasses.replace(snap))
                torch.cuda.synchronize()
                cold_s = time.perf_counter() - t0
                del cold
            del full
            out_results, launches = verify(step, snap, ov_content if ov_arg is not None else {})
            timings.setdefault(step, {})[layout_name] = {
                "mode": mode, "patch_ms": patch_s * 1e3, "patch_event_ms": patch_ev,
                "full_ms": full_s * 1e3, "snapshot_ms": snap_s * 1e3,
                "cold_full_ms": None if cold_s is None else cold_s * 1e3}
            cold_txt = ("" if cold_s is None else
                        f", a cold full load (layout build included) {cold_s * 1e3:.2f} ms")
            log(f"{tag} churn[{layout_name}] {step}: load_tables {mode}, {patch_s * 1e3:.2f} ms "
                f"host clock ({patch_ev:.2f} ms CUDA events) against a full upload "
                f"{full_s * 1e3:.2f} ms ({full_s / patch_s:.1f}x){cold_txt}; snapshot + hint "
                f"{snap_s * 1e3:.2f} ms; launches {launches}; oracle on "
                f"{', '.join(f'{k} {len(v)}' for k, v in subsets.items())} packets and the "
                f"recount equal; rule hits {int((out_results != 0).sum())}")
        # the overlay side on the operands it is served with: K1 over the
        # overlay's dense layout, and K2 over the overlay's own padded trie
        # (the layout an overlay K1 cannot hold is served on), each against
        # its plain version on both columns, then both sides in the combine
        dev, ov_dev = clf._active.dev, clf._active.ov
        n_lv = dev.n_levels if layout_name == "trie" else None
        fields, words = torchpath.packet_fields(torchpath.device_batch(batch, device))
        if not isinstance(ov_dev, dense.DenseTables):
            raise SystemExit(f"churn[{layout_name}]: the overlay is not served on K1")
        ov_trie = walk.build_trie_tables(ov, device, pad=True)
        for name, got, want in (
                ("dense_classify (K1) over the overlay", dense.dense_classify(fields, words, ov_dev),
                 dense.dense_classify_plain(fields, words, ov_dev)),
                ("trie_walk (K2) over the overlay's trie",
                 walk.trie_walk_classify(fields, words, ov_trie, ov_trie.n_levels),
                 walk.trie_walk_classify_plain(fields, words, ov_trie, ov_trie.n_levels))):
            if not torch.equal(got, want):
                raise SystemExit(f"churn[{layout_name}]: {name} disagrees with its plain version "
                                 f"({int((got != want).any(dim=1).sum().item())} packets)")
        dbatch = torchpath.device_batch(batch, device)
        if not torch.equal(overlay.combined_results(dev, ov_dev, dbatch, n_lv),
                           overlay.combined_results(dev, ov_trie, dbatch, n_lv)):
            raise SystemExit(f"churn[{layout_name}]: the K1 and K2 overlay sides combine "
                             f"differently")
        del got, want, dbatch
        log(f"churn[{layout_name}]: overlay K1 layout: {k1_groups(dense, ov_dev)}")
        log(f"churn[{layout_name}]: K1 over the {ov.num_entries}-entry overlay and K2 over its "
            f"padded trie ({ov_trie.n_levels} levels) equal their plain versions on both columns "
            f"for all {len(batch)} packets; both combine to the same results")
        # the device pass with and without the overlay, on the narrow wire
        wire = torch.from_numpy(narrow_wire(batch.pack_wire()).view(np.int32)).to(device)
        plain_pass = ((lambda: cwalk.classify_ctrie_wire_fused(dev, wire)) if layout_name == "ctrie"
                      else (lambda: walk.classify_walk_wire_fused(dev, wire, n_lv)))
        with_ov = cuda_ms(lambda: overlay.classify_overlay_wire_fused(dev, ov_dev, wire, n_lv), 10)
        without = cuda_ms(plain_pass, 10)
        k1_ms = cuda_ms(lambda: dense.dense_classify(fields, words, ov_dev), 10)
        k2_ms = cuda_ms(lambda: walk.trie_walk_classify(fields, words, ov_trie, ov_trie.n_levels),
                        10)
        with_k2 = cuda_ms(lambda: overlay.classify_overlay_wire_fused(dev, ov_trie, wire, n_lv), 10)
        timings.setdefault("device pass", {})[layout_name] = {
            "with_overlay_ms": with_ov, "without_ms": without, "k1_overlay_ms": k1_ms,
            "k2_overlay_ms": k2_ms, "with_k2_overlay_ms": with_k2}
        if layout_name == "ctrie":  # K3's fused entry against the composed pass
            timings["device pass"]["ctrie"]["fused_turns"] = fused_turns(
                tag, f"churn[ctrie] without the overlay, {len(batch)} packets, narrow wire",
                plain_pass, lambda: composed_ctrie(cwalk, torchpath, dev, wire))
        log(f"{tag} churn[{layout_name}] device pass ({len(batch)} packets, narrow wire, CUDA "
            f"events): {without:.4f} ms without the overlay, {with_ov:.4f} ms with it (K1 over "
            f"the {ov.num_entries}-entry overlay alone {k1_ms:.4f} ms); with the overlay on K2 "
            f"over its trie instead {with_k2:.4f} ms (K2 alone {k2_ms:.4f} ms)")
        del dev, ov_dev, ov_trie, wire, fields, words

        # the edit transactions, through a TxnApplier over the same
        # IncrementalTables and classifier; its overlay starts empty, so
        # the churn overlay leaves service at its first load
        applier = txn.TxnApplier(clf, it, stats=txn.TxnStats())
        t0 = time.perf_counter()
        ops = testing.generate_edit_ops(np.random.default_rng(4244), 64, it, CHURN_WIDTH)
        draw_s = time.perf_counter() - t0
        rep, ms, ev_ms = timed_flush(applier, ops)
        _res, launches = verify("txn", clf.tables, applier.overlay)
        kinds = {k: sum(op.kind == k for op in ops) for k in sorted({op.kind for op in ops})}
        log(f"{tag} churn[{layout_name}] txn (one 64-op transaction, ops {kinds}, drawn in "
            f"{draw_s:.2f} s): {rep.n_ops} ops, {rep.n_folded} folded, load {rep.mode}, "
            f"{rep.dirty_rows} rows shipped, escalated {rep.escalated}, overlay "
            f"{len(applier.overlay)} keys; {ms:.2f} ms host clock ({ev_ms:.2f} ms CUDA events) "
            f"per flush; launches {launches}; the fresh build, plain versions, oracle and "
            f"recount equal")
        txn_t = {"mix": {"ops": rep.n_ops, "folded": rep.n_folded, "mode": rep.mode,
                         "rows": rep.dirty_rows, "ms": ms, "event_ms": ev_ms}}
        # bench_churn's A/B on live keys: one-edit generations (AB_ONE_EDITS a round,
        # the script's time limit) against one folded 64-edit transaction,
        # per edit, interleaved, the min of 2 rounds
        keys = list(applier.updater.content)
        rules_only = lambda n: [txn.EditOp("rules_edit", k, r) for k, r in mk_edits(n).items()]
        timed_flush(applier, rules_only(1))  # the first edit's one-time costs
        seq, folded_ms, seq_rows, folded_rows = [], [], [], []
        for _round in range(2):
            t0 = time.perf_counter()
            for op in rules_only(AB_ONE_EDITS):
                r1, _ms, _ev = timed_flush(applier, [op])
                if r1.mode != "patch":
                    raise SystemExit(f"churn[{layout_name}] txn A/B: a one-edit generation "
                                     f"loaded by {r1.mode}")
                seq_rows.append(r1.dirty_rows)
            seq.append((time.perf_counter() - t0) * 1e3 / AB_ONE_EDITS)
            r64, ms, _ev = timed_flush(applier, rules_only(64))
            if r64.mode != "patch":
                raise SystemExit(f"churn[{layout_name}] txn A/B: the folded transaction loaded "
                                 f"by {r64.mode}")
            folded_ms.append(ms / 64)
            folded_rows.append(r64.dirty_rows)
        # six more folded flushes, every second one under the profiler:
        # their copies and kernels
        r64, ops_per_flush = flush_operations(lambda: applier.apply(rules_only(64)))
        _res, launches = verify("txn A/B", clf.tables, applier.overlay)
        log(f"{tag} churn[{layout_name}] txn A/B ({AB_ONE_EDITS} one-edit generations against 64 "
            f"rules-only edits folded, 2 rounds interleaved): "
            f"per edit {min(seq):.3f} ms as one-edit generations (rounds {seq[0]:.3f}, "
            f"{seq[1]:.3f}; {sum(seq_rows) / len(seq_rows):.1f} rows each) against "
            f"{min(folded_ms):.3f} ms folded (rounds {folded_ms[0]:.3f}, {folded_ms[1]:.3f}; "
            f"{folded_rows} rows per flush), {min(seq) / min(folded_ms):.1f}x, host clock; one "
            f"folded flush under the profiler ({r64.dirty_rows} rows): {ops_per_flush}; "
            f"launches {launches}; the fresh build, plain versions, oracle and recount equal")
        txn_t["ab"] = {"seq_ms_per_edit": seq, "folded_ms_per_edit": folded_ms,
                       "seq_rows_mean": sum(seq_rows) / len(seq_rows),
                       "folded_rows": folded_rows, "profiled_flush": ops_per_flush}
        timings.setdefault("txn", {})[layout_name] = txn_t
        by_layout[layout_name] = results
        clf.close()
        del it, clf
    for a, b in zip(by_layout["trie"], by_layout["ctrie"]):
        if not np.array_equal(a, b):
            raise SystemExit("churn: the trie and ctrie layouts disagree")
    log(f"churn: the trie and ctrie layouts agree on the whole batch after every step; phase "
        f"{time.perf_counter() - phase_t0:.2f} s (host clock), of which {len(oracles)} "
        f"restricted HashLpmOracle builds (oracle_for) {oracle_s:.2f} s")
    return timings


#: K5's tables: the tool's (4096, 128), one row, narrow rows, a width past
#: one warp's load, and (65536, 8), above the rows whose sums the kernel
#: stages (gather.STAGED_MAX_ROWS); the batches held against the plain version
K5_SHAPES = ((4096, 128), (1, 4), (4096, 4), (5000, 256), (65536, 8))
K5_BATCHES = (1, 3, 1023, 1025, 1 << 20, (1 << 20) + 3)
#: the shapes timed at B = 2^20: the tool's table and the above-cap branch
K5_TIMED = ((4096, 128), (65536, 8))


def k5_table(rng, n: int, w: int):
    import torch

    return torch.from_numpy(rng.integers(0, 2**32, (n, w), dtype=np.int64).astype(np.uint32)
                            .view(np.int32)).to("cuda")


def parent_k5_run(idx, table):
    """A call of --parent's K5 on ``idx`` and ``table`` (a row-sum scratch
    for a parent of the cooperative design)."""
    import torch

    b, (n, w) = idx.shape[0], table.shape
    old = k5_scratchless(PARENT_KERNELS["gather_rowsum"].csrc)
    sums = torch.empty((n + 3) // 4 * 4, dtype=torch.int32, device=idx.device)

    def args():
        out = torch.empty(b, dtype=torch.int32, device=idx.device)
        ptrs = (idx.data_ptr(), table.data_ptr()) + (() if old else (sums.data_ptr(),))
        return out, ptrs + (out.data_ptr(), b, n, w)

    return parent_run("gather_rowsum", args)


def gather_phase(tag: str) -> dict:
    """K5 against its plain version (exact) on both branches, at every
    shape of K5_SHAPES and batch of K5_BATCHES, indices outside [0, N) and
    the int32 edges among them, at the co-resident grid and a forced grid
    of 3 blocks; at B = 2^20 over each of K5_TIMED its CUDA-event and
    device times (the profiler must show one gather_rowsum_kernel and no
    memset a call) against its bound, the plain version and index_select +
    sum (with --parent, the parent's K5 in turns); then the main path: a
    short run of infw_torch/tools/profile_gather.py's ladder and K5 chain.
    Returns K5's kernels-line entry."""
    import torch

    from infw_torch.kernels import all_kernels, gather
    from infw_torch.tools import profile_gather

    rng = np.random.default_rng(23)
    err = 0
    for n, w in K5_SHAPES:
        table = k5_table(rng, n, w)
        outside = 0
        for b in K5_BATCHES:
            idx_np = rng.integers(0, n, b).astype(np.int64)
            idx_np[::97] = rng.integers(-(2**31), 2**31, len(idx_np[::97]), dtype=np.int64)
            idx_np[: min(b, 3)] = [2**31 - 1, -(2**31), n][: min(b, 3)]
            idx_np = idx_np.astype(np.int32)
            outside += int(((idx_np < 0) | (idx_np >= n)).sum())
            idx = torch.from_numpy(idx_np).to("cuda")
            want = gather.gather_rowsum_plain(idx, table)
            for grid in (0, 3):
                got = gather.gather_rowsum(idx, table, _grid=grid)
                torch.cuda.synchronize()
                mism = int((got != want).sum().item())
                err = max(err, int((got.long() - want.long()).abs().max().item()))
                if mism:
                    raise SystemExit(f"K5 disagrees with its plain version at ({n}, {w}), B={b}, "
                                     f"grid cap {grid}: {mism} rows")
        branch = ("sums staged in shared memory" if n <= gather.STAGED_MAX_ROWS
                  else "sums read through L2")
        log(f"K5 vs plain [({n}, {w}), {branch}]: B = {', '.join(map(str, K5_BATCHES))}, "
            f"co-resident grid and 3 blocks: mismatching rows=0 ({outside} indices outside "
            f"[0, {n - 1}])")
    timed = {}
    for n, w in K5_TIMED:
        table = k5_table(rng, n, w)
        idx = torch.from_numpy(rng.integers(0, n, 1 << 20).astype(np.int32)).to("cuda")
        b = idx.shape[0]
        k5_fn = lambda: gather.gather_rowsum(idx, table)
        t = {"ms": cuda_ms(k5_fn, reps=50)}
        per_call, fills = {}, {}
        device_us = profiled_kernels(k5_fn, reps=20, counts=per_call, memsets=fills)
        if (len(per_call) != 1 or "gather_rowsum_kernel" not in next(iter(per_call))
                or list(per_call.values()) != [1.0] or fills):
            raise SystemExit(f"K5 ({n}, {w}): the profiler shows kernels per call {per_call} and "
                             f"memsets {fills}, expected one gather_rowsum_kernel and no memset")
        t["device_ms"] = sum(device_us.values()) / 1e3
        t["paced_ms"] = device_paced_ms(k5_fn)
        t["host_ms"] = host_ms_per_call(k5_fn)
        t["plain_ms"] = cuda_ms(lambda: gather.gather_rowsum_plain(idx, table), reps=5, warmup=1)
        t["library_ms"] = cuda_ms(
            lambda: table.index_select(0, idx).sum(dim=1, dtype=torch.int32), reps=20)
        moved = b * 4 + n * w * 4 + b * 4
        t["bound_ms"] = moved / HBM_BYTES_PER_S * 1e3
        if PARENT_KERNELS:
            parent_fn = parent_k5_run(idx, table)
            t["parent_in_turns"] = parent_turns(tag, f"K5 ({n}, {w}), B={b}", k5_fn, parent_fn)
            # the host paces this tree's calls: in turns again with the host ahead
            p1, t1, t2, p2 = (device_paced_ms(fn) for fn in (parent_fn, k5_fn, k5_fn, parent_fn))
            t["parent_in_turns"].update(paced_ms=(t1 + t2) / 2, parent_paced_ms=(p1 + p2) / 2)
            log(f"{tag} parent vs this tree [K5 ({n}, {w}), B={b}], with the host ahead, in "
                f"turns: parent {p1:.5f}, {p2:.5f} ms; this {t1:.5f}, {t2:.5f} ms; this / parent "
                f"{(t1 + t2) / (p1 + p2):.3f}")
        log(f"{tag} K5 gather_rowsum [({n}, {w}) u32, B={b}]: {t['ms']:.4f} ms, profiler device "
            f"time {t['device_ms'] * 1e3:.2f} us a call (one kernel, no memset); bound "
            f"{t['bound_ms']:.4f} ms by bytes ({moved / 1e6:.2f} MB: indices, table and sums "
            f"once each, over 3.35 TB/s; the row-sum scratch and its staging are the design's and "
            f"not counted); {t['ms'] / t['bound_ms']:.2f}x its bound by events, "
            f"{t['device_ms'] / t['bound_ms']:.2f}x by device time; with the host ahead "
            f"{t['paced_ms']:.5f} ms a call; host {t['host_ms'] * 1e3:.2f} us a call")
        log(f"{tag} K5 plain version [({n}, {w})]: {t['plain_ms']:.4f} ms; library call "
            f"index_select + sum: {t['library_ms']:.4f} ms")
        timed[(n, w)] = (t, table, idx)
    head, table, idx = timed[K5_TIMED[0]]
    slope_s = profile_gather.slope(profile_gather.k5_step(table), idx, "K5 chain (phase)",
                                   min_span=0.05)
    log(f"{tag} K5 chained step (K5 + add + mod, two-point slope) at ({table.shape[0]}, "
        f"{table.shape[1]}): {slope_s * 1e3:.4f} ms")
    # the main path: the port's profiling tool, launch counts zeroed first
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    ladder = profile_gather.main(["--min-span", "0.05"])
    launches = {k.name: k.launches for k in kernels if k.launches}
    log(f"gather main path: python -m infw_torch.tools.profile_gather --min-span 0.05 in "
        f"{time.perf_counter() - t0:.2f} s, launches {launches}; " + ", ".join(
            f"{k} {v * 1e3:.4f} ms/step" for k, v in ladder.items()))
    if set(launches) != {"gather_rowsum"}:
        raise SystemExit("the gather tool must launch gather_rowsum and nothing else")
    above, _, _ = timed[K5_TIMED[1]]
    return {
        "name": "gather_rowsum",
        "route": "cuda",
        "source": "infw_torch/kernels/csrc/gather_rowsum.cu",
        "replaces": "tools/profile_gather.py:92",
        "launches": launches["gather_rowsum"],
        "mismatches": 0,
        "max_abs_err": err,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": "bytes",
        "library_ms": head["library_ms"],
        **{k: head[k] for k in ("device_ms", "paced_ms", "host_ms", "parent_in_turns")
           if k in head},
        "slope_step_ms": slope_s * 1e3,
        "above_cap": {"table": list(K5_TIMED[1]), **above},
    }


# the daemon phase: a NodeState file and frames files through the port's
# daemon (bench config 5a of the JAX package, bench.py bench_replay_10m)
# bench config 5a's replay: 2 of its 10 files of 1M frames a pass (10 until
# the script's time limit cut them); 2 passes (3 until the telemetry phase
# came in)
REPLAY_FILES, REPLAY_PACKETS, REPLAY_PASSES = 2, 1_000_000, 2
DAEMON_NODE = "node-0"
DAEMON_IFACES = {"eth0": 2, "eth1": 3, "eth2": 4}


def _wait(cond, what: str, timeout: float = 300.0, every: float = 0.005) -> float:
    """Poll ``cond`` until it holds; seconds waited.  Fails the script on
    timeout."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise SystemExit(f"daemon: timed out waiting for {what}")
        time.sleep(every)
    return time.perf_counter() - t0


def _metric(d, name: str) -> int:
    import urllib.request

    body = urllib.request.urlopen(f"http://127.0.0.1:{d.actual_metrics_port}/metrics",
                                  timeout=10).read().decode()
    for line in body.splitlines():
        if line.startswith(f"ingressnodefirewall_node_{name} "):
            return int(line.split()[1])
    raise SystemExit(f"/metrics has no {name}")


def copy_overlap(prof) -> tuple:
    """From a torch.profiler trace: (milliseconds of host-to-device copy,
    of them the milliseconds during which a kernel ran on the card, the
    copies' kinds by name, milliseconds during which any kernel ran)."""
    from torch.autograd import DeviceType

    copies, kernels, names = [], [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        if e.name.startswith("Memcpy"):
            names[e.name] = names.get(e.name, 0) + 1
            if "HtoD" in e.name:
                copies.append(span)
        elif not e.name.startswith("Memset"):
            kernels.append(span)
    kernels.sort()
    merged = []
    for s, t in kernels:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    total = sum(t - s for s, t in copies)
    over = 0.0
    for s, t in copies:
        for ks, kt in merged:
            if kt > s and ks < t:
                over += min(t, kt) - max(s, ks)
    busy = sum(t - s for s, t in merged)
    return total / 1e3, over / 1e3, names, busy / 1e3


def stage_split(d, wall: float) -> str:
    """The daemon's stage seconds of the last pass (Daemon.stage_seconds,
    file-loop thread) and the rest of the wall time (between ticks)."""
    parts = ", ".join(f"{k} {v:.3f}" for k, v in d.stage_seconds.items())
    return (f"stage split (s): {parts}, outside the ticks "
            f"{wall - sum(d.stage_seconds.values()):.3f}")


def check_daemon_files(d, files, reference, label: str, n_check: int = ORACLE_PACKETS) -> dict:
    """Every file's summary against a host recount of its verdict sidecar,
    its first ``n_check`` packets against ``reference`` (an oracle's
    classify of the parsed frames, or a tuple of classifies when edits land
    during the pass: each packet must equal one of them); returns the
    recounted statistics and deny count, and per reference the packets
    that equal it and no other."""
    from infw_torch.backend.base import stats_from_results
    from infw_torch.obs import pcap

    stats = np.zeros((1024, 4), np.int64)
    denies = 0
    only = None
    for name, fb in files:
        res = np.fromfile(os.path.join(d.out_dir, name + ".verdicts.bin"), "<u4")
        summary = json.load(open(os.path.join(d.out_dir, name + ".verdicts.json")))
        parsed = pcap.parse_frames_buf(fb)
        drop = (parsed.kind == 0) | ((res & 0xFF) == 1)
        want = {"file": name, "packets": len(fb), "pass": int((~drop).sum()),
                "drop": int(drop.sum()), "results_file": name + ".verdicts.bin"}
        if len(res) != len(fb) or summary != want:
            raise SystemExit(f"{label}: {name}'s summary {summary} disagrees with its "
                             f"verdicts {want}")
        n = min(n_check, len(fb))
        sub = pcap.FramesBuf(fb.buf, fb.offsets[:n], fb.lengths[:n], fb.ifindex[:n])
        refs = reference(pcap.parse_frames_buf(sub))
        refs = refs if isinstance(refs, tuple) else (refs,)
        hits = np.stack([res[:n] == r.results for r in refs])
        if not hits.any(axis=0).all():
            raise SystemExit(f"{label}: {name} disagrees with the oracle on its first "
                             f"{n} packets")
        alone = hits & (hits.sum(axis=0) == 1)
        only = alone.sum(axis=1) if only is None else only + alone.sum(axis=1)
        stats += stats_from_results(res, parsed.pkt_len)
        denies += int(((res & 0xFF) == 1).sum())
    return {"stats": stats, "denies": denies, "only": [int(c) for c in only]}


def check_daemon_counters(d, clf, before: dict, got: dict, label: str) -> None:
    """The daemon's statistics against the recount, the deny events
    (decoded spill rows, and no lost sample) against the deny verdicts (the
    ring's other records: one patch-txn line per edit flush), the /metrics
    deny counter against the statistics."""
    from infw_torch.obs import events

    delta = clf.stats.snapshot() - before["stats"]
    if not np.array_equal(delta, got["stats"]):
        raise SystemExit(f"{label}: the daemon's statistics disagree with the verdicts")
    spill = os.path.join(d.state_dir, "deny-events.bin")
    row = events.BatchDenyRecord.SPILL_DTYPE.itemsize
    size = lambda: os.path.getsize(spill) if os.path.exists(spill) else 0
    _wait(lambda: size() >= before["spill"] + got["denies"] * row, "the deny-event spill", 60)
    d.events_logger.drain_once()
    rows = np.fromfile(spill, events.BatchDenyRecord.SPILL_DTYPE)[before["spill"] // row:]
    flushes = d.txn_stats.snapshot()["txns"] - before["txns"]
    small = d.ring.queued_total - before["queued"] - len(rows) - flushes
    if (len(rows) != got["denies"] or not ((rows["result"] & 0xFF) == 1).all()
            or d.ring.lost_samples or small):
        raise SystemExit(f"{label}: {len(rows)} spilled deny events (+{small} as lines, "
                         f"{d.ring.lost_samples} lost) for {got['denies']} deny verdicts")
    want = int(clf.stats.snapshot()[1:100, 2].sum())
    _wait(lambda: _metric(d, "packet_deny_total") == want, "the /metrics deny counter", 30, 0.05)
    log(f"{label}: summaries, oracle subsets, statistics, {got['denies']} deny events "
        f"(spill rows, 0 lost) and /metrics deny total {want}: equal")


def daemon_phase(tag: str, iface_rules: dict) -> dict:
    """The port's daemon as a user runs it (infw_torch.daemon.Daemon, the
    default cuda backend, threads started): the headline dense NodeState,
    then the 100K-CIDR trie state re-adopted from a checkpoint and bench
    config 5a's replay, then one pass under compressed=True.  Returns
    {pass: {kernel name: launches}} for the dense pass, the trie replay's
    passes summed, and the compressed pass."""
    import shutil

    import torch

    from infw_torch import compiler, daemon, oracle, spec, testing, txn
    from infw_torch.compiler import LazyContent
    from infw_torch.interfaces import Interface, InterfaceRegistry
    from infw_torch.kernels import all_kernels
    from infw_torch.obs import pcap
    from infw_torch.packets import concat
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    kernels = all_kernels()
    registry = InterfaceRegistry()
    for name, index in DAEMON_IFACES.items():
        registry.add(Interface(name=name, index=index))
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "daemon-smoke")
    shutil.rmtree(root, ignore_errors=True)
    daemons = []

    def start(name: str, **kw):
        d = daemon.Daemon(state_dir=os.path.join(root, name), node_name=DAEMON_NODE,
                          registry=registry, metrics_port=0, health_port=0,
                          poll_period_s=0.1, file_poll_interval_s=0.02, **kw)
        daemons.append(d)
        return d

    def write_state(d, doc):
        p = os.path.join(d.nodestates_dir, f"{DAEMON_NODE}.json")
        with open(p + ".tmp", "w") as f:
            json.dump(doc, f)
        os.replace(p + ".tmp", p)

    def ready(d) -> bool:
        """Serving: the classifier holds tables and the sync that loaded
        them has returned (attached_interfaces takes the syncer's lock,
        which the file loop holds to the end of the sync: the diff against
        a re-adopted checkpoint, the manifest)."""
        c = d.syncer.classifier
        return c is not None and c.tables is not None and bool(d.syncer.attached_interfaces())

    def counters(d):
        clf = d.syncer.classifier
        return {"stats": clf.stats.snapshot(), "queued": d.ring.queued_total,
                "txns": d.txn_stats.snapshot()["txns"],
                "spill": os.path.getsize(os.path.join(d.state_dir, "deny-events.bin"))
                if os.path.exists(os.path.join(d.state_dir, "deny-events.bin")) else 0}

    def run_pass(d, files, label: str, before=None, during=None):
        """Stage the files, zero the counts, call ``before`` (when given),
        move them into ingest/, call ``during`` (when given) and wait for
        every summary; returns (seconds, launches)."""
        stage = os.path.join(d.state_dir, "staging")
        os.makedirs(stage, exist_ok=True)
        for name, fb in files:
            daemon.write_frames_file_v2(os.path.join(stage, name), fb)
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        d.stage_seconds.update(dict.fromkeys(d.stage_seconds, 0.0))
        if before is not None:
            before()
        t0 = time.perf_counter()
        for name, _fb in files:
            os.replace(os.path.join(stage, name), os.path.join(d.ingest_dir, name))
        if during is not None:
            during()
        last = [os.path.join(d.out_dir, name + ".verdicts.json") for name, _fb in files]
        _wait(lambda: all(os.path.exists(p) for p in last), f"{label}'s summaries", 600, 0.002)
        dt = time.perf_counter() - t0
        return dt, {k.name: k.launches for k in kernels if k.launches}

    try:
        # 1. the headline dense state as one NodeState file
        doc = {"metadata": {"name": DAEMON_NODE},
               "spec": {"interfaceIngressRules": iface_rules}}
        ns = spec.IngressNodeFirewallNodeState.from_dict(doc)
        dense_tables = compiler.compile_tables(ns.spec.interface_ingress_rules, registry)
        d = start("dense")
        d.start()
        t0 = time.perf_counter()
        write_state(d, doc)
        _wait(lambda: ready(d), "the dense NodeState", 300)
        clf = d.syncer.classifier
        log(f"daemon dense: NodeState of {dense_tables.num_entries} entries synced in "
            f"{time.perf_counter() - t0:.3f} s; path {clf.active_path} on {clf.device}")
        if clf.active_path != "dense" or clf.device.type != "cuda":
            raise SystemExit("daemon: the headline state must serve on the dense path on the card")
        b = testing.random_batch_fast(np.random.default_rng(40), dense_tables, HEADLINE_PACKETS)
        fb = pcap.build_frames_bulk(b.kind, b.ip_words, b.proto, b.dst_port, b.icmp_type,
                                    b.icmp_code, l4_ok=b.l4_ok)
        fb.ifindex = np.asarray(b.ifindex, np.uint32)
        before = counters(d)
        dt, launches = run_pass(d, [("dense.frames", fb)], "the dense file")
        by_pass = {"dense": launches}
        log(f"{tag} daemon dense: 1 file x {len(fb)} frames in {dt:.3f} s = "
            f"{len(fb) / dt / 1e6:.3f} M packets/s, launches {launches}; {stage_split(d, dt)}")
        if launches.get("dense_classify", 0) <= 0 or set(launches) != {"dense_classify"}:
            raise SystemExit(f"daemon: the dense state must launch K1 and nothing else: {launches}")
        got = check_daemon_files(d, [("dense.frames", fb)],
                                 lambda sub: oracle.classify(dense_tables, sub), "daemon dense")
        check_daemon_counters(d, clf, before, got, "daemon dense")
        d.stop()

        # 2. bench config 5a: the 100K-CIDR trie state, re-adopted from a
        # checkpoint the port's CompiledTables.save wrote, as a restart
        # finds it (the NodeState file beside it, unchanged)
        t0 = time.perf_counter()
        doc = testing.random_nodestate(np.random.default_rng(31), DAEMON_NODE, DAEMON_IFACES,
                                       TRIE_ENTRIES, width=TRIE_WIDTH)
        ns = spec.IngressNodeFirewallNodeState.from_dict(doc)
        tables = compiler.compile_tables(ns.spec.interface_ingress_rules, registry)
        compile_s = time.perf_counter() - t0
        ck = os.path.join(root, "trie", "checkpoint")
        os.makedirs(ck)
        t0 = time.perf_counter()
        tables.save(os.path.join(ck, "tables.npz"))
        with open(os.path.join(ck, "manifest.json"), "w") as f:
            json.dump({"attached": sorted(DAEMON_IFACES)}, f)
        save_s = time.perf_counter() - t0
        shutil.copytree(ck, os.path.join(root, "ctrie", "checkpoint"))
        log(f"daemon trie: NodeState of {tables.num_entries} entries x {tables.rule_width} rule "
            f"slots compiled in {compile_s:.2f} s (host), checkpoint written in {save_s:.2f} s "
            f"({os.path.getsize(os.path.join(ck, 'tables.npz')) / 1e6:.1f} MB)")
        d = start("trie")
        write_state(d, doc)
        t0 = time.perf_counter()
        d.start()
        _wait(lambda: ready(d), "the re-adopted trie state", 300)
        clf = d.syncer.classifier
        adopted = d.syncer._updater is None and isinstance(clf.tables.content, LazyContent)
        log(f"daemon trie: started and serving in {time.perf_counter() - t0:.2f} s "
            f"(re-adopted the checkpoint: {adopted}); path {clf.active_path}, "
            f"{clf.tables.levels} levels, attached {sorted(d.syncer.attached_interfaces())}")
        if not adopted or clf.active_path != "trie":
            raise SystemExit("daemon: the trie state must be re-adopted from the checkpoint "
                             "and served on the trie path")

        t0 = time.perf_counter()
        b = testing.random_batch_fast(np.random.default_rng(32), tables, REPLAY_PACKETS)
        fb = pcap.build_frames_bulk(b.kind, b.ip_words, b.proto, b.dst_port, b.icmp_type,
                                    b.icmp_code, l4_ok=b.l4_ok)
        base_ifx = np.asarray(b.ifindex, np.uint32)
        hashed = oracle.HashLpmOracle(tables)
        # the ifindex rotation of bench.py:897-910: every (pass, file) is
        # distinct, hit and miss traffic as in the generated batch
        live = np.asarray(tables.mask_len[: tables.num_entries]) >= 0
        dom = np.unique(np.asarray(tables.key_words[: tables.num_entries, 0])[live]).astype(np.uint32)
        pos = np.searchsorted(dom, base_ifx)
        pos_ok = (pos < len(dom)) & (dom[np.minimum(pos, len(dom) - 1)] == base_ifx)
        log(f"daemon replay: {REPLAY_PACKETS} frames synthesized in "
            f"{time.perf_counter() - t0:.2f} s ({len(fb.buf) / 1e6:.1f} MB per file)")

        def pass_files(p: int, n_files: int = REPLAY_FILES):
            out = []
            for i in range(n_files):
                k = p * REPLAY_FILES + i
                ifx = np.where(pos_ok, dom[(pos + k) % len(dom)], base_ifx).astype(np.uint32)
                out.append((f"p{p}-f{i:02d}.frames",
                            pcap.FramesBuf(fb.buf, fb.offsets, fb.lengths, np.roll(ifx, 977 * k))))
            return out

        def replay_pass(d, p: int, label: str, reference=None):
            clf = d.syncer.classifier
            files = pass_files(p)
            before = counters(d)
            ws0 = clf.wire_stats()
            dt, launches = run_pass(d, files, label)
            ws = {k: tuple(v - ws0.get(k, (0, 0))[j] for j, v in enumerate(vals))
                  for k, vals in clf.wire_stats().items()}
            got = check_daemon_files(d, files, reference or hashed.classify, label)
            check_daemon_counters(d, clf, before, got, label)
            n = REPLAY_FILES * REPLAY_PACKETS
            log(f"{tag} {label}: {REPLAY_FILES} x {REPLAY_PACKETS} frames in {dt:.3f} s = "
                f"{n / dt / 1e6:.3f} M packets/s; launches {launches}; {stage_split(d, dt)}; "
                f"wire {ws}")
            return dt, launches, ws

        def land_edits(d, name: str, ops) -> float:
            """Write an edit file beside edits/ and move it in; the moment
            it landed (host clock)."""
            stage = os.path.join(d.state_dir, "edit-staging")
            os.makedirs(stage, exist_ok=True)
            txn.write_edit_file(os.path.join(stage, name), ops)
            t = time.perf_counter()
            os.replace(os.path.join(stage, name), os.path.join(d.edits_dir, name))
            return t

        def wait_flushed(d, ops_before: int, n_ops: int) -> float:
            """Wait until the flushes counted ``n_ops`` more ops, edits/ is
            empty and no flush runs; the moment the count was reached."""
            want = ops_before + n_ops
            _wait(lambda: d.txn_stats.snapshot()["ops"] >= want, "the edit flush", 300, 0.0005)
            t = time.perf_counter()
            _wait(lambda: not os.listdir(d.edits_dir) and not (
                d._edit_flush_thread is not None and d._edit_flush_thread.is_alive()),
                "edits/ to drain", 60)
            if d.txn_stats.snapshot()["ops"] != want:
                raise SystemExit(f"daemon edits: {d.txn_stats.snapshot()['ops']} ops flushed, "
                                 f"expected {want}")
            return t

        def aimed_batch(rng, content: dict, n: int):
            """A batch of ``n`` packets inside ``content``'s prefixes."""
            t = compiler.compile_tables_from_content(content, rule_width=TRIE_WIDTH)
            b = testing.random_batch_fast(rng, t, n, hit_fraction=1.0)
            return b

        def frames_of(b):
            fb_ = pcap.build_frames_bulk(b.kind, b.ip_words, b.proto, b.dst_port, b.icmp_type,
                                         b.icmp_code, l4_ok=b.l4_ok)
            fb_.ifindex = np.asarray(b.ifindex, np.uint32)
            return fb_

        def edit_pass(d, tables):
            """The replay state's edit pass: one DEFAULT_MAX_OPS-op file of
            the generator's full mix, a 1M-frame file against the oracle of
            the edited content (the first 2^17 packets, 20480 of them aimed
            at the edited and deleted prefixes) and a recount; then 256
            rules edits in four files landing while a pass is in flight,
            each packet's verdict the oracle's before or after them.
            Returns the launches of each part."""
            clf = d.syncer.classifier
            pre = {k: v for k, v in clf.tables.content.items()}
            ops = testing.generate_edit_ops(np.random.default_rng(33), txn.DEFAULT_MAX_OPS,
                                            tables, TRIE_WIDTH)
            kinds = {k: sum(op.kind == k for op in ops) for k in sorted({op.kind for op in ops})}
            for k in kernels:
                k.launches = 0
            before = d.txn_stats.snapshot()
            t_land = land_edits(d, "e0.json", ops)
            visible = wait_flushed(d, before["ops"], len(ops)) - t_land
            flush_launches = {k.name: k.launches for k in kernels if k.launches}
            after = d.txn_stats.snapshot()
            if after["txns"] != before["txns"] + 1 or (
                    after["reasons"].get("batch", 0) != before["reasons"].get("batch", 0) + 1):
                raise SystemExit(f"daemon edits: expected one 'batch' flush: {before} -> {after}")
            counters_now = d.txn_stats.counter_values()
            for name, value in counters_now.items():
                if _metric(d, name) != value:
                    raise SystemExit(f"daemon edits: /metrics {name} disagrees with the counters")
            post = dict(d.syncer._content)
            log(f"{tag} daemon edit: {len(ops)} ops ({kinds}) visible {visible * 1e3:.1f} ms "
                f"after the file landed (one 'batch' flush, load {clf._last_load}, overlay "
                f"{len(d.syncer._overlay)} keys); patch_txn_* {counters_now}; launches during "
                f"the flush {flush_launches}")
            # the post-edit file: packets aimed at the edited prefixes, at the
            # deleted ones, then the edited table at large
            t0 = time.perf_counter()
            rng = np.random.default_rng(34)
            edited = {op.key.masked_identity() for op in ops}
            live = {k.masked_identity() for k in post}
            parts = [aimed_batch(rng, {k: v for k, v in post.items()
                                        if k.masked_identity() in edited}, 16384)]
            gone = {k: v for k, v in pre.items()
                    if k.masked_identity() in edited and k.masked_identity() not in live}
            if gone:
                parts.append(aimed_batch(rng, gone, 4096))
            n_rest = REPLAY_PACKETS - sum(len(p_) for p_ in parts)
            parts.append(testing.random_batch_fast(
                rng, compiler.compile_tables_from_content(post, rule_width=TRIE_WIDTH), n_rest))
            files = [("edit-f0.frames", frames_of(concat(parts)))]
            post_oracle = oracle.HashLpmOracle(_Content(post))
            prep_s = time.perf_counter() - t0
            before_c = counters(d)
            dt, launches = run_pass(d, files, "the post-edit file")
            got = check_daemon_files(d, files, post_oracle.classify, "daemon edit", n_check=1 << 17)
            check_daemon_counters(d, clf, before_c, got, "daemon edit")
            for k, v in flush_launches.items():
                launches[k] = launches.get(k, 0) + v
            log(f"{tag} daemon edit: the post-edit file ({REPLAY_PACKETS} frames, made in "
                f"{prep_s:.2f} s) in {dt:.3f} s = {REPLAY_PACKETS / dt / 1e6:.3f} M packets/s; "
                f"launches {launches}; oracle of the edited content on the first {1 << 17} "
                f"packets, the recount and the counters equal")
            if launches.get("trie_walk", 0) <= 0 or (d.syncer._overlay and
                                                     launches.get("dense_classify", 0) <= 0):
                raise SystemExit(f"daemon edit: K2 (and K1 over the overlay) must serve the "
                                 f"edited tables: {launches}")
            edit_launches = launches

            # rules edits of 256 live keys in four files, landing in flight
            rng = np.random.default_rng(35)
            keys = list(post)
            pick = rng.choice(len(keys), 256, replace=False)
            late = [txn.EditOp("rules_edit", keys[int(i)], testing.random_rules(rng, TRIE_WIDTH))
                    for i in pick]
            post2 = dict(post)
            post2.update({op.key: op.rules for op in late})
            aimed = frames_of(aimed_batch(rng, {op.key: op.rules for op in late}, 65536))
            base_files = pass_files(REPLAY_PASSES + 2, 4)
            pre_o, post_o = post_oracle, oracle.HashLpmOracle(_Content(post2))
            both = lambda sub: (pre_o.classify(sub), post_o.classify(sub))
            before_c = counters(d)
            before = d.txn_stats.snapshot()
            landed = []

            def drop(js):
                for j in js:
                    landed.append(land_edits(d, f"late-{j}.json", late[64 * j: 64 * (j + 1)]))
                    time.sleep(0.05)

            # two files land just before the frames: the next tick queues
            # them and its admissions trip their flush mid-pass; two land
            # while the tick runs, queued after it
            dt, launches = run_pass(d, base_files + [("p9-z-aimed.frames", aimed)],
                                    "the in-flight pass", before=lambda: drop((0, 1)),
                                    during=lambda: drop((2, 3)))
            done = wait_flushed(d, before["ops"], len(late))
            after = d.txn_stats.snapshot()
            got = check_daemon_files(d, base_files, both, "daemon in-flight", n_check=16384)
            got_a = check_daemon_files(d, [("p9-z-aimed.frames", aimed)], both,
                                       "daemon in-flight", n_check=65536)
            check_daemon_counters(d, clf, before_c, {
                "stats": got["stats"] + got_a["stats"], "denies": got["denies"] + got_a["denies"]},
                "daemon in-flight")
            reasons = {r: c - before["reasons"].get(r, 0) for r, c in after["reasons"].items()}
            log(f"{tag} daemon in-flight: 4 edit files of 64 rules edits landed "
                f"{(landed[-1] - landed[0]) * 1e3:.0f} ms apart, two before and two after the "
                f"frames of a pass of 4 x "
                f"{REPLAY_PACKETS} + 65536 frames ({dt:.3f} s); {after['txns'] - before['txns']} "
                f"flushes {reasons}, the last visible {(done - landed[-1]) * 1e3:.1f} ms after it landed; every "
                f"checked packet is the oracle's before or after them (aimed file: "
                f"{got_a['only'][0]} only before, {got_a['only'][1]} only after); edits/ empty; "
                f"launches {launches}")
            return edit_launches, launches

        times, total = [], {}
        by_pass["trie"] = total
        for p in range(REPLAY_PASSES):
            dt, launches, ws = replay_pass(d, p, f"daemon replay pass {p}")
            times.append(dt)
            if launches.get("trie_walk", 0) <= 0:
                raise SystemExit(f"daemon replay: K2 was not launched: {launches}")
            if (ws.get("delta", (0, 0))[0] > 0) != (launches.get("wire_decode", 0) > 0):
                raise SystemExit(f"daemon replay: K4 launches {launches} do not match the "
                                 f"delta chunks {ws}")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
        n = REPLAY_FILES * REPLAY_PACKETS
        log(f"{tag} daemon replay (bench config 5a, 100K trie, {REPLAY_PASSES} passes): "
            f"min {n / max(times) / 1e6:.3f} / median {n / float(np.median(times)) / 1e6:.3f} / "
            f"max {n / min(times) / 1e6:.3f} M packets/s; wire_stats() {clf.wire_stats()}")

        # where the copies went: two files under the profiler, the copies'
        # time beside the time a kernel ran at the same moment
        files = pass_files(REPLAY_PASSES, 2)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            dt, _launches = run_pass(d, files, "the profiled files")
        copy_ms, over_ms, names, busy_ms = copy_overlap(prof)
        log(f"{tag} daemon trace (2 files, {dt:.3f} s under the profiler): host-to-device "
            f"copies {copy_ms:.3f} ms, of which {over_ms:.3f} ms overlapped a kernel; copies by "
            f"kind {names}; a kernel ran during {busy_ms:.3f} ms (the card idle "
            f"{100 * (1 - busy_ms / 1e3 / dt):.2f}% of the pass)")

        # 3. edit files on the replay state: one file of DEFAULT_MAX_OPS ops
        # of the generator's full mix (a "batch" flush), then a file aimed at
        # what it changed; then rules edits landing while a pass is in flight
        by_pass["trie edit"], by_pass["trie in-flight"] = edit_pass(d, tables)
        d.stop()

        # 4. one pass under compressed=True: the ctrie path and the fused K3
        d = start("ctrie", compressed=True)
        write_state(d, doc)
        t0 = time.perf_counter()
        d.start()
        _wait(lambda: ready(d), "the compressed state", 300)
        clf = d.syncer.classifier
        log(f"daemon ctrie: re-adopted and serving in {time.perf_counter() - t0:.2f} s; "
            f"path {clf.active_path}")
        if clf.active_path != "ctrie":
            raise SystemExit("daemon: compressed=True must serve the ctrie path")
        # an edit file first (no new CIDRs, so no overlay): both K3 entries
        # then run on patched tables, the fused one and, for the delta
        # chunks, the two-column one
        ops = [op for op in testing.generate_edit_ops(np.random.default_rng(36), 512, tables,
                                                      TRIE_WIDTH) if op.kind != "cidr_add"]
        before = d.txn_stats.snapshot()
        t_land = land_edits(d, "c0.json", ops)
        visible = wait_flushed(d, before["ops"], len(ops)) - t_land
        if d.syncer._overlay:
            raise SystemExit("daemon compressed: the edit file filled the overlay")
        edited = oracle.HashLpmOracle(_Content(dict(d.syncer._content)))
        log(f"{tag} daemon ctrie edit: {len(ops)} ops visible {visible * 1e3:.1f} ms after the "
            f"file landed; load {clf._last_load}")
        dt, launches, _ws = replay_pass(d, REPLAY_PASSES + 1, "daemon replay compressed",
                                        reference=edited.classify)
        if launches.get("ctrie_wire_fused", 0) <= 0 or launches.get("ctrie_walk", 0) <= 0:
            raise SystemExit(f"daemon compressed: K3's fused and two-column entries must both "
                             f"run after the patch: {launches}")
        by_pass["ctrie"] = launches
        d.stop()
        log(f"daemon phase: {time.perf_counter() - t_phase:.1f} s")
        return by_pass
    finally:
        for d in daemons:
            if d._threads:
                d.stop()
        shutil.rmtree(root, ignore_errors=True)


# -- the tenant arena, rules-only patches, the dense family, the overlay ------

# the daemon's --tenants arena at the JAX daemon's default slab geometry
# (infw/daemon.py:1019-1055: 1024 entries x 16 rule slots, tenants + 2
# pages) for 64 tenants (the arena tier's 512, cut for the script's time
# limit), each filled by one edit file of about 1000 key_adds, 16 of them
# with byte-identical content; 16384 packets per tenant (2^20 in all)
TENANT_COUNT, TENANT_KEYS, TENANT_SHARED, TENANT_PER = 64, 1000, 16, 16384
# the JAX bench's production-sized clone-then-patch (bench.py:2418-2470)
CLONE_ENTRIES = 200_000
# the dense-family arena: 512 tenants x S = 1024 rows x 16 rule slots,
# 2048 packets per tenant (2^20 in all)
DENSE_TENANTS, DENSE_SLAB, DENSE_SLOTS, DENSE_ENTRIES = 512, 1024, 16, 1000
DENSE_PER = 2048
# the overlay side-pool: the syncer's overlay cap (infw/syncer.py
# OVERLAY_CAP) as the slab rows, 16 rule slots
OVERLAY_CAP, OVERLAY_SLOTS = 1024, 16
# K6's operations per k-step of a (packet, live slab row) compare: the
# LPM's int8 product over 32 key bits, a multiply and an add each, against
# the card's dense int8 rate (K1's formulation, 2 x 160 for a whole key)
K6_OPS_PER_KSTEP = 2 * 32
#: the device of the tenant, clone, dense-arena and overlay phases
DEV = "cuda"
#: the dense arena of dense_arena_phase (spec, tables, the destroyed tenant,
#: its stateless classifier), kept for the flow phase
DENSE_ARENA: dict = {}


def timed_device(fn):
    """(result, host ms, CUDA-event ms) of one call, the card idle before
    and synchronized after."""
    import torch

    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, start.elapsed_time(stop)


def spread(xs) -> str:
    xs = sorted(xs)
    return (f"min {xs[0]:.2f} / median {xs[len(xs) // 2]:.2f} / max {xs[-1]:.2f}"
            if xs else "none")


def tenant_keys_edit(txn, content, t: int, n: int = 8):
    """A rules-only edit file's ops for one tenant: ``n`` of its keys (from
    a position that depends on ``t``) with rule slot 1 replaced."""
    keys = sorted(content, key=lambda k: (k.ingress_ifindex, k.ip_data, k.prefix_len))
    ops = []
    for j in range(n):
        k = keys[(37 * t + 11 * j) % len(keys)]
        r = np.zeros((2, 7), np.int32)
        r[: len(content[k])] = np.asarray(content[k])[:2]
        r[1] = [1 + (t + j) % 250, 6, 1000 + t % 60000, 0, 0, 0, 1 + j % 2]
        ops.append(txn.EditOp(kind="key_add", key=k, rules=r))
    return ops


def tenant_phase(tag: str) -> dict:
    """The port's daemon with --tenants TENANT_COUNT on the card (threads
    started, the default slab geometry): one creating edit file per tenant
    dir landed at once (TENANT_SHARED tenants with identical content share
    a page), then
    one rules-only file per tenant (private pages "patch", the shared ones
    "cow"), one swap, one destroy, a dedup sweep once two clones
    re-converged; then a 2^20-packet classify_mixed across the tenants
    (ids -1, >= TENANT_COUNT and the destroyed one among them): one launch of K3b's
    fused entry, bit for bit against the plain K3b and each updater's
    per-tenant oracle.  Returns the readings for the kernels line."""
    import shutil

    import torch

    from infw_torch import daemon, oracle, testing, txn
    from infw_torch.kernels import all_kernels, arena_walk, torchpath
    from infw_torch.packets import concat, narrow_wire

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "tenant-smoke")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    shared = testing.random_content_fast(np.random.default_rng(5000), TENANT_KEYS, width=2)
    contents = [shared if t < TENANT_SHARED else testing.random_content_fast(
        np.random.default_rng(5000 + t), TENANT_KEYS, width=2) for t in range(TENANT_COUNT)]
    names = [f"t{t:04d}" for t in range(TENANT_COUNT)]
    staging = os.path.join(root, "staging")
    for name, content in zip(names, contents):
        os.makedirs(os.path.join(staging, name, "edits"))
        txn.write_edit_file(os.path.join(staging, name, "edits", "e0.json"),
                            [txn.EditOp(kind="key_add", key=k, rules=r) for k, r in content.items()])
    gen_s = time.perf_counter() - t0
    d = daemon.Daemon(state_dir=os.path.join(root, "state"), node_name=DAEMON_NODE,
                      backend=DEV, metrics_port=0, health_port=0, poll_period_s=0.1,
                      file_poll_interval_s=0.02, tenants=TENANT_COUNT)
    reg = d.tenant_registry
    clf = reg.classifier
    spec = clf.spec
    log(f"tenants: Daemon(tenants={TENANT_COUNT}) spec {spec}; pool "
        f"{clf.allocator.pool_bytes() / 1e6:.1f} MB; {TENANT_COUNT} contents of {TENANT_KEYS} "
        f"keys ({TENANT_SHARED} identical) and their edit files in {gen_s:.2f} s")
    calls = []  # (kind, result, host ms, event ms, end time)

    def timed_method(name: str, kind: str):
        fn = getattr(reg, name)

        def run(*a, **kw):
            out, host_ms, ev_ms = timed_device(lambda: fn(*a, **kw))
            calls.append((kind, out, host_ms, ev_ms, time.perf_counter(), a[0]))
            return out

        setattr(reg, name, run)

    timed_method("create_tenant", "create")
    timed_method("apply_edit_transaction", "txn")
    d.start()
    try:
        def land(round_name: str, move) -> tuple:
            """Land every tenant's file at once, wait until all are consumed;
            (landing time, seconds to the last)."""
            calls.clear()
            t_land = time.perf_counter()
            move()
            waited = _wait(lambda: all(not os.listdir(os.path.join(d.tenants_dir, n, "edits"))
                                       for n in names if os.path.isdir(
                                           os.path.join(d.tenants_dir, n, "edits"))) and
                           sum(c[0] == "txn" for c in calls) >= TENANT_COUNT,
                           f"the {round_name} edit files", timeout=600, every=0.01)
            return t_land, waited

        # round 1: the creating files, every tenant dir landed at once
        t_land, waited = land("creating", lambda: [
            os.rename(os.path.join(staging, n), os.path.join(d.tenants_dir, n)) for n in names])
        creates = [c for c in calls if c[0] == "create"]
        fills = [c for c in calls if c[0] == "txn"]
        paths = {}
        for c in fills:
            paths[c[1]] = paths.get(c[1], 0) + 1
        visible = [(c[4] - t_land) * 1e3 for c in fills]
        log(f"{tag} tenants create round: {len(creates)} creates, host ms {spread([c[2] for c in creates])}, "
            f"CUDA events ms {spread([c[3] for c in creates])}; {len(fills)} filling files "
            f"(paths {paths}), host ms {spread([c[2] for c in fills])}, CUDA events ms "
            f"{spread([c[3] for c in fills])}; edit file to visible ms {spread(visible)}; all "
            f"{TENANT_COUNT} consumed {waited * 1e3:.1f} ms after landing")
        if len(reg.tenant_names()) != TENANT_COUNT:
            raise SystemExit(f"tenants: {len(reg.tenant_names())} tenants created")
        pages = {clf.allocator.page_of(reg.tenant_id(n)) for n in names[:TENANT_SHARED]}
        if len(pages) != 1 or clf.allocator.distinct_slabs() != TENANT_COUNT - TENANT_SHARED + 1:
            raise SystemExit(f"tenants: the {TENANT_SHARED} identical tenants are on pages "
                             f"{sorted(pages)}, {clf.allocator.distinct_slabs()} distinct slabs")

        # round 2: one rules-only file per tenant; tenants 1 and 2 take the
        # same edit, so their clones re-converge
        for t, n in enumerate(names):
            upd = reg._updaters[reg.tenant_id(n)]
            ops = tenant_keys_edit(txn, dict(upd.content), 1 if t == 2 else t)
            txn.write_edit_file(os.path.join(staging, f"{n}.json"), ops)
        t_land, waited = land("rules-only", lambda: [
            os.rename(os.path.join(staging, f"{n}.json"),
                      os.path.join(d.tenants_dir, n, "edits", "e1.json")) for n in names])
        paths = {}
        by_path = {}
        for c in calls:
            paths[c[1]] = paths.get(c[1], 0) + 1
            by_path.setdefault(c[1], []).append(c)
        visible = [(c[4] - t_land) * 1e3 for c in calls]
        log(f"{tag} tenants rules-only round: paths {paths}; "
            + "; ".join(f"{p} host ms {spread([c[2] for c in cs])}, CUDA events ms "
                        f"{spread([c[3] for c in cs])}" for p, cs in sorted(by_path.items()))
            + f"; edit file to visible ms {spread(visible)}; all consumed {waited * 1e3:.1f} ms "
            f"after landing")
        if paths != {"patch": TENANT_COUNT - TENANT_SHARED + 1, "cow": TENANT_SHARED - 1}:
            raise SystemExit(f"tenants: the rules-only round took paths {paths}")

        # a swap, a destroy, the dedup sweep
        swapped, gone = names[5], names[9]
        new = testing.random_content_fast(np.random.default_rng(4999), TENANT_KEYS, width=2)
        _, swap_ms, swap_ev = timed_device(lambda: reg.swap_tenant(swapped, new))
        gone_id = reg.tenant_id(gone)
        # the directory goes first, or the file loop creates the tenant anew
        shutil.rmtree(os.path.join(d.tenants_dir, gone))
        _, destroy_ms, _ = timed_device(lambda: reg.destroy_tenant(gone))
        p1, p2 = (clf.allocator.page_of(reg.tenant_id(n)) for n in names[1:3])
        rep, sweep_ms, _ = timed_device(lambda: clf.dedup_sweep())
        q1, q2 = (clf.allocator.page_of(reg.tenant_id(n)) for n in names[1:3])
        log(f"{tag} tenants: swap of {swapped} {swap_ms:.2f} ms host ({swap_ev:.3f} ms events), "
            f"destroy of {gone} {destroy_ms:.2f} ms; dedup sweep {sweep_ms:.2f} ms: "
            f"{rep['hashed']} pages re-hashed, {rep['merged']} rows merged; {names[1]} and "
            f"{names[2]} on pages {p1}, {p2} -> {q1}, {q2}")
        if p1 == p2 or q1 != q2 or rep["merged"] < 1:
            raise SystemExit("tenants: the re-converged clones were not merged")

        # 2^20 packets across the tenants through classify_mixed
        snaps = {n: reg._updaters[reg.tenant_id(n)].snapshot() for n in reg.tenant_names()}
        parts, tags = [], []
        for t, n in enumerate(names):
            tab = snaps.get(n, snaps[names[0]])
            parts.append(testing.random_batch_fast(np.random.default_rng(6000 + t), tab,
                                                   TENANT_PER))
            tags.append(np.full(TENANT_PER, t if n != gone else gone_id, np.int64))
        batch = concat(parts)
        tag_ids = np.concatenate(tags)
        tag_ids[::257] = -1
        tag_ids[1::263] = TENANT_COUNT
        tag_ids[2::269] = TENANT_COUNT + 12345
        tag_ids[3::271] = 2**32 + 1
        name_of = {reg.tenant_id(n): n for n in reg.tenant_names()}
        kernels = all_kernels()
        for k in kernels:
            k.launches = 0
        out, mixed_ms, _ = timed_device(lambda: reg.classify_mixed(batch, tag_ids.tolist()))
        launches = {k.name: k.launches for k in kernels if k.launches}
        log(f"{tag} tenants classify_mixed({len(batch)}): {mixed_ms:.2f} ms host, launches "
            f"{launches}")
        if launches != {"arena_wire_fused": 1}:
            raise SystemExit("tenants: classify_mixed must launch K3b's fused entry once and "
                             "nothing else")
        check_recount(batch, out.results, out.stats_delta, "tenants classify_mixed")
        t32 = np.where((tag_ids >= 0) & (tag_ids < TENANT_COUNT), tag_ids, -1).astype(np.int32)
        wire = torch.from_numpy(narrow_wire(batch.pack_wire()).view(np.int32)).to(DEV)
        tdev = torch.from_numpy(t32).to(DEV)
        kw = {"pages": spec.pages, "d_max": spec.d_max}
        pool = clf.allocator.arena
        err = check_fused(f"tenants fused K3b [{TENANT_COUNT} tenants, classify_mixed's wire]",
                          lambda: arena_walk.classify_arena_wire_fused(pool, wire, tdev, **kw),
                          lambda: arena_walk.classify_arena_wire_fused_plain(pool, wire, tdev,
                                                                             **kw), len(batch))
        fused = arena_walk.classify_arena_wire_fused(pool, wire, tdev, **kw).cpu().numpy()
        res16, _st = torchpath.split_wire_outputs(fused, len(batch))
        if not np.array_equal(torchpath.host_finalize_wire(res16, batch.kind)[0], out.results):
            raise SystemExit("tenants: classify_mixed disagrees with the fused K3b's buffer")
        bad = ~np.isin(tag_ids, list(name_of))
        if out.results[bad].any():
            raise SystemExit("tenants: invalid, destroyed or out-of-range ids are not UNDEF")
        checked = 0
        for tid, n in name_of.items():
            idx = np.nonzero(tag_ids == tid)[0][:16]
            r = oracle.classify(snaps[n], batch.take(idx))
            if not (np.array_equal(out.results[idx], r.results)
                    and np.array_equal(out.xdp[idx], r.xdp)):
                raise SystemExit(f"tenants: {n} disagrees with its updater's oracle")
            checked += len(idx)
        log(f"{tag} tenants: classify_mixed equal to the plain K3b on all {len(batch)} packets, "
            f"to each updater's oracle on {checked} packets of {len(name_of)} tenants; "
            f"{int(bad.sum())} lanes of ids -1, {TENANT_COUNT}, {TENANT_COUNT + 12345}, 2^32 + 1 "
            f"and the destroyed {gone} UNDEF; rule hits {int((out.results != 0).sum())}")
        text = d.metrics_registry.render_text()
        lines = [l.split("ingressnodefirewall_node_")[-1] for l in text.splitlines()
                 if "_tenant_" in l and not l.startswith("#") and not re.search(r"tenant_\d", l)]
        log(f"{tag} tenants /metrics: " + ", ".join(lines))
        d.events_logger.drain_once()
        kinds = {}
        for rec_line in open(d.events_path).read().splitlines():
            m = re.match(r"tenant-(\w+):", rec_line)
            if m:
                kinds[m.group(1)] = kinds.get(m.group(1), 0) + 1
        log(f"{tag} tenants events.log: {kinds}")
        if kinds != {"create": TENANT_COUNT, "swap": 1, "destroy": 1}:
            raise SystemExit(f"tenants: events.log holds {kinds}")
    finally:
        d.stop()
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": launches.get("arena_wire_fused", 0), "max_abs_err": err,
            "classify_mixed_ms": mixed_ms}


def clone_phase(tag: str) -> None:
    """The JAX bench's clone-then-patch at production size
    (bench.py:2418-2470): a 200K-entry slab shared by two tenants, a third
    joining it, then one rules-only edit of the third: "cow", timed (min of
    3) against a full re-bake of the edited table, and "patch" on the now
    private page; the cloned slab's bytes equal a cold bake of the edited
    table, on the host mirror and on the card."""
    import torch

    from infw_torch import arena, oracle, testing
    from infw_torch.compiler import IncrementalTables
    from infw_torch.kernels import arena_walk, torchpath

    t0 = time.perf_counter()
    base = testing.clean_tables_fast(np.random.default_rng(777), CLONE_ENTRIES, width=4)
    content = dict(base.content)
    spec = arena.arena_spec_for("ctrie", (base,), pages=6, max_tenants=8, headroom=1.5)
    al = arena.ArenaAllocator(spec, DEV)
    paths = [al.load_tenant(0, base), al.load_tenant(1, base)]
    build_s = time.perf_counter() - t0
    k_edit = sorted(content, key=lambda k: (k.ingress_ifindex, k.ip_data))[0]
    best = {"cow": [], "patch": [], "rebake": []}
    for i in range(3):
        upd = IncrementalTables.from_content(dict(content), rule_width=4)
        if al.load_tenant(2, upd.snapshot()) != "share" or not al.tenant_shares_page(2):
            raise SystemExit("clone: the third tenant did not join the shared slab")
        upd.start_dirty_tracking()
        r = np.asarray(content[k_edit]).copy()
        r[1] = [1, 6, 1000 + i, 0, 0, 0, 2]
        upd.apply({k_edit: r}, [])
        hint, snap1 = upd.peek_dirty(), upd.snapshot()
        upd.clear_dirty()
        path, host_ms, ev_ms = timed_device(lambda: al.load_tenant(2, snap1, hint=hint))
        if path != "cow":
            raise SystemExit(f"clone: the shared slab's rules-only edit took {path!r}")
        best["cow"].append((host_ms, ev_ms))
        if i == 0:
            cold = arena.ArenaAllocator(spec, DEV)
            cold.load_tenant(0, snap1)
            p, q = al.page_of(2), cold.page_of(0)
            same = all(np.array_equal(a, b) for a, b in zip(al._canonical_of_page(p),
                                                            cold._canonical_of_page(q)))
            rows = dict(zip(("l0", "nodes", "targets", "joined", "root_lut"), al._slab_rows()))
            dev_same = all(np.array_equal(
                getattr(al.arena, f)[p * n:(p + 1) * n].cpu().numpy(),
                al._host[f][p * n:(p + 1) * n].view(getattr(al.arena, f).cpu().numpy().dtype))
                for f, n in rows.items())
            b = testing.random_batch_fast(np.random.default_rng(778), snap1, ORACLE_PACKETS)
            o = arena_walk.classify_arena_wire_fused(
                al.arena, torch.from_numpy(b.pack_wire().view(np.int32)).to(DEV),
                torch.full((len(b),), 2, dtype=torch.int32, device=DEV),
                pages=spec.pages, d_max=spec.d_max).cpu().numpy()
            res16, _ = torchpath.split_wire_outputs(o, len(b))
            want = oracle.HashLpmOracle(snap1).classify(b)
            is_ip = ((b.kind == 1) | (b.kind == 2)) & (b.l4_ok != 0)
            oracle_ok = np.array_equal(np.where(is_ip, res16, 0), want.results & 0xFFFF)
            log(f"clone @{CLONE_ENTRIES}: the cloned slab against a cold bake of the edited "
                f"table: host mirror {'equal' if same else 'DIFFERENT'}, the card's pool rows "
                f"{'equal' if dev_same else 'DIFFERENT'} to the mirror; tenant 2's "
                f"{len(b)} packets {'equal' if oracle_ok else 'DIFFERENT'} to the oracle")
            if not (same and dev_same and oracle_ok):
                raise SystemExit("clone: the cloned slab is not the edited table's bake")
            del cold
        r2 = r.copy()
        r2[1] = [1, 17, 2000 + i, 0, 0, 0, 1]
        upd.apply({k_edit: r2}, [])
        hint2, snap2 = upd.peek_dirty(), upd.snapshot()
        path, host_ms, ev_ms = timed_device(lambda: al.load_tenant(2, snap2, hint=hint2))
        if path != "patch":
            raise SystemExit(f"clone: the private slab's rules-only edit took {path!r}")
        best["patch"].append((host_ms, ev_ms))
        al.destroy_tenant(2)
        upd3 = IncrementalTables.from_content(dict(content), rule_width=4)
        upd3.apply({k_edit: r}, [])
        snap3 = upd3.snapshot()
        path, host_ms, ev_ms = timed_device(lambda: al.load_tenant(3, snap3))
        if path != "assign":
            raise SystemExit(f"clone: the re-bake took {path!r}")
        best["rebake"].append((host_ms, ev_ms))
        al.destroy_tenant(3)
    m = {k: (min(h for h, _e in v), min(e for _h, e in v)) for k, v in best.items()}
    log(f"{tag} clone-then-patch @{CLONE_ENTRIES} entries (spec {spec}, build {build_s:.2f} s, "
        f"paths {paths}): cow {m['cow'][0]:.2f} ms host ({m['cow'][1]:.3f} ms events) against a "
        f"full re-bake {m['rebake'][0]:.2f} ms ({m['rebake'][1]:.3f} ms events) = "
        f"{m['rebake'][0] / m['cow'][0]:.1f}x; patch of the private page {m['patch'][0]:.2f} ms "
        f"({m['patch'][1]:.3f} ms events); min of 3")


def dense_bound(arena_dense, torchpath, pool, wire, tenant, pages: int):
    """K6's fused-entry bound: (ms, "bytes" | "operations", bytes, ops,
    row compares, k-steps).  Bytes: the wire, tenant, results and
    statistics once, then for the lanes finalize keeps (IP with an L4
    header) whose tenant holds a page: its page-table entry, the key,
    mask and length of each live row (mask_len >= 0) of every slab they
    reach, and the rule row of each distinct winning row.  Operations:
    K6_OPS_PER_KSTEP for each k-step (32 key bits) that each such lane's
    compares need: a compare against a live row (mask_len 0..128) of the
    lane's slab needs the key words the row's mask covers (its last
    non-zero mask word + 1, at least 1), and an IPv4 lane compares only
    the rows up to /32, the longest it can match."""
    import torch

    fields, words, mask = looked_up_operands(torchpath, wire)
    S = pool.mask_len.shape[0] // pages
    t = tenant.long()
    MT = pool.page_table.shape[0]
    pt = pool.page_table.long()
    pg = torch.where(mask & (t >= 0) & (t < MT), pt[t.clamp(0, MT - 1)], -1)
    keep = pg >= 0
    ml = pool.mask_len.view(-1, S).long()
    live = (ml >= 0) & (ml <= 128)
    short = live & (ml <= 32)
    covered = (pool.mask_words != 0).long() * torch.arange(1, 6, device=ml.device)
    steps = covered.max(dim=1).values.clamp(min=1).view(-1, S)
    v4 = (fields[:, 0] == arena_dense.KIND_IPV4)[keep]
    lane_pg = pg[keep]
    compares = int(torch.where(v4, short.sum(1)[lane_pg], live.sum(1)[lane_pg]).sum().item())
    ksteps = int(torch.where(v4, (steps * short).sum(1)[lane_pg],
                             (steps * live).sum(1)[lane_pg]).sum().item())
    ops = ksteps * K6_OPS_PER_KSTEP
    read = (ml >= 0).sum(dim=1)
    pages_read = torch.unique(lane_pg)
    won = []
    f, w, tk = fields[keep], words[keep], tenant[keep]
    step = max(1, arena_dense.PLAIN_ROWS // S)
    for s in range(0, f.shape[0], step):
        _rows, score, win = arena_dense.arena_dense_rows(
            pool, torchpath.batch_from_fields(f[s:s + step], w[s:s + step]), tk[s:s + step], pages)
        won.append(win[score > 0])
    n_won = torch.unique(torch.cat(won)).numel() if won else 0
    nbytes = (fused_bound(wire, tenant, {})[1] + torch.unique(t[keep]).numel() * 4
              + int(read[pages_read].sum().item()) * 44 + n_won * pool.rules.shape[1] * 2)
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    return (max(b_ms, o_ms), ("operations" if o_ms > b_ms else "bytes"), nbytes, ops, compares,
            ksteps)


def k6_check(label: str, arena_dense, pool, fields, words, tt, wires, kw) -> int:
    """K6's two-column entry against its plain version on (fields, words,
    tt), and its fused entry on each (wire, tenant) of ``wires``: every
    word equal; returns the largest absolute difference (0)."""
    import torch

    got = arena_dense.arena_dense_classify(fields, words, tt, pool, **kw)
    want = arena_dense.arena_dense_classify_plain(fields, words, tt, pool, **kw)
    torch.cuda.synchronize()
    mism = int((got != want).any(dim=1).sum().item())
    err = int((got.long() - want.long()).abs().max().item()) if got.numel() else 0
    log(f"K6 two-column vs plain [{label}]: B={got.shape[0]} mismatching packets={mism} "
        f"max_abs_err={err} matched={int((got[:, 1] > 0).sum().item())}")
    if mism:
        raise SystemExit(f"K6 disagrees with its plain version [{label}]")
    for width, (w, tw) in wires.items():
        err = max(err, check_fused(
            f"fused K6 [{label}, width {width}]",
            lambda w=w, tw=tw: arena_dense.classify_arena_dense_wire_fused(pool, w, tw, **kw),
            lambda w=w, tw=tw: arena_dense.classify_arena_dense_wire_fused_plain(pool, w, tw, **kw),
            w.shape[0]))
    return err


def dense_arena_phase(tag: str) -> dict:
    """The dense-family arena (jaxpath.make_arena_spec("dense", 514, 512,
    1024, 16)): 512 tenant tables of 1000 entries x 16 rule slots loaded
    through TorchArenaClassifier, a 2^20-packet mixed batch with ids -1,
    512 and a destroyed tenant; K6's two-column and fused entries against
    the plain versions on it (grouped by tenant), on the same packets
    shuffled, on 2^20 packets of one tenant and on one packet per tenant,
    and the formulation (arena_dense.formulation) against the kernel on
    16 tenants' packets; the main path (one call of K6's fused entry,
    nothing else) against the per-tenant oracles; K6's times on the
    grouped and the shuffled batch and its two kernels' device times (the
    profiler must show one of each per call), the cooperative kernel's
    time with every lane "none" and on a pool without live rows (the
    grouping, the staging and the product apart), --parent's K6 in turns,
    its bound and compare count.  Returns its kernels-line entry."""
    import torch

    from infw_torch import arena, oracle, testing
    from infw_torch.backend.cuda import TorchArenaClassifier
    from infw_torch.kernels import all_kernels, arena_dense, torchpath
    from infw_torch.packets import concat, narrow_wire

    t0 = time.perf_counter()
    tabs = [testing.random_tables_fast(np.random.default_rng(7000 + t), DENSE_ENTRIES, width=DENSE_SLOTS,
                                       v6_fraction=0.3) for t in range(DENSE_TENANTS)]
    gen_s = time.perf_counter() - t0
    spec = arena.make_arena_spec("dense", DENSE_TENANTS + 2, DENSE_TENANTS, DENSE_SLAB,
                                 DENSE_SLOTS)
    clf = TorchArenaClassifier(spec, device=DEV)
    t0 = time.perf_counter()
    paths = [clf.load_tenant(t, tab) for t, tab in enumerate(tabs)]
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    gone = DENSE_TENANTS - 1
    clf.destroy_tenant(gone)
    if set(paths) != {"assign"}:
        raise SystemExit(f"dense arena loads took paths {sorted(set(paths))}")
    pool = clf.allocator.arena
    log(f"dense arena: spec {spec}; pool {clf.allocator.pool_bytes() / 1e6:.1f} MB; "
        f"{DENSE_TENANTS} tables {gen_s:.2f} s, loads {load_s:.2f} s; tenant {gone} destroyed")
    parts = [testing.random_batch_fast(np.random.default_rng(7500 + t), tab, DENSE_PER)
             for t, tab in enumerate(tabs)]
    batch = concat(parts)
    tenant = np.repeat(np.arange(DENSE_TENANTS, dtype=np.int32), DENSE_PER)
    tenant[::251], tenant[1::257] = -1, DENSE_TENANTS
    B = len(batch)
    kw = {"pages": spec.pages}
    order = np.random.default_rng(7001).permutation(B)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)

    # K6 against its plain versions on every packet of four batches: the
    # cell's (grouped by tenant), the same packets shuffled, 2^20 packets of
    # one tenant, one packet per tenant
    fields, words = torchpath.packet_fields(torchpath.device_batch(batch, DEV))
    tt = put(tenant)
    wires = {w: (x, tw) for w, (x, _m, tw, _i) in fused_wires(batch, tenant).items()}
    err = k6_check(f"{DENSE_TENANTS} tenants x {DENSE_SLAB} rows, grouped", arena_dense, pool,
                   fields, words, tt, wires, kw)
    shuffled, s_tenant = batch.take(order), tenant[order]
    s_fields, s_words = torchpath.packet_fields(torchpath.device_batch(shuffled, DEV))
    s_wires = {w: (x, tw) for w, (x, _m, tw, _i) in fused_wires(shuffled, s_tenant).items()}
    err = max(err, k6_check("shuffled", arena_dense, pool, s_fields, s_words, put(s_tenant),
                            s_wires, kw))
    one = testing.random_batch_fast(np.random.default_rng(7002), tabs[3], B)
    o_fields, o_words = torchpath.packet_fields(torchpath.device_batch(one, DEV))
    o_tenant = np.full(B, 3, np.int32)
    err = max(err, k6_check("2^20 packets of tenant 3", arena_dense, pool, o_fields, o_words,
                            put(o_tenant), {7: (put(one.pack_wire().view(np.int32)),
                                                put(o_tenant))}, kw))
    firsts = np.arange(DENSE_TENANTS) * DENSE_PER
    per = batch.take(firsts)
    p_fields, p_words = torchpath.packet_fields(torchpath.device_batch(per, DEV))
    p_tenant = np.arange(DENSE_TENANTS, dtype=np.int32)
    err = max(err, k6_check("one packet per tenant", arena_dense, pool, p_fields, p_words,
                            put(p_tenant), {7: (put(per.pack_wire().view(np.int32)),
                                                put(p_tenant))}, kw))
    # the kernel's arithmetic step by step (the plain formulation, whose
    # int64 product runs on the host) on 16 tenants
    sub = np.nonzero((tenant >= 0) & (tenant < 16))[0]
    sub_t = put(tenant[sub])
    f16, w16 = fields[put(sub).long()], words[put(sub).long()]
    got16 = arena_dense.arena_dense_classify(f16, w16, sub_t, pool, **kw).cpu()
    form = arena_dense.formulation(f16.cpu(), w16.cpu(), sub_t.cpu(),
                                   arena.DenseArena(*(t.cpu() for t in pool)), **kw)
    if not torch.equal(form, got16):
        raise SystemExit("K6 disagrees with its formulation on 16 tenants")
    log(f"K6 against its formulation (page buckets, staged chunks, the integer product): "
        f"{len(sub)} packets of 16 tenants equal")

    # the main path: one mixed classify, K6's fused entry once, nothing else
    wire = batch.pack_wire()
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    out, main_ms, _ = timed_device(lambda: clf.classify_async_packed_tenant(wire, tenant).result())
    launches = {k.name: k.launches for k in kernels if k.launches}
    log(f"dense arena main path: classify_async_packed_tenant({B}) {main_ms:.2f} ms (first call), "
        f"launches {launches}")
    if launches != {"arena_dense_fused": 1}:
        raise SystemExit("the dense arena main path must launch arena_dense_fused once and "
                         "nothing else")
    check_recount(batch, out.results, out.stats_delta, "dense arena main path")
    off = (tenant < 0) | (tenant >= DENSE_TENANTS) | (tenant == gone)
    if out.results[off].any():
        raise SystemExit("dense arena: lanes of invalid or destroyed tenants are not UNDEF")
    for t in range(DENSE_TENANTS - 1):
        idx = np.nonzero(tenant == t)[0][:8]
        r = oracle.classify(tabs[t], batch.take(idx))
        if not (np.array_equal(out.results[idx], r.results) and np.array_equal(out.xdp[idx], r.xdp)):
            raise SystemExit(f"dense arena: tenant {t} disagrees with its oracle")
    log(f"dense arena main path: equal to the per-tenant oracles on 8 packets x "
        f"{DENSE_TENANTS - 1} tenants; {int(off.sum())} lanes of ids -1, {DENSE_TENANTS} and the "
        f"destroyed {gone} UNDEF; rule hits {int((out.results != 0).sum())}")

    # timings on the main path's narrow wire, grouped and shuffled
    nw_np = narrow_wire(wire)
    nw, ntt = put(nw_np.view(np.int32)), put(tenant)
    snw, sntt = put(nw_np[order].view(np.int32)), put(s_tenant)
    run = lambda: arena_dense.classify_arena_dense_wire_fused(pool, nw, ntt, **kw)
    run_s = lambda: arena_dense.classify_arena_dense_wire_fused(pool, snw, sntt, **kw)
    two = lambda: arena_dense.arena_dense_classify(fields, words, tt, pool, **kw)
    s_tt = put(s_tenant)
    two_s = lambda: arena_dense.arena_dense_classify(s_fields, s_words, s_tt, pool, **kw)
    fused_ms, fused_s_ms = cuda_ms(run, reps=10), cuda_ms(run_s, reps=10)
    per_call = {}
    device_us = profiled_kernels(run, reps=3, counts=per_call)
    short = lambda k: next((n for n in ("arena_dense_kernel", "rule_scan_kernel") if n in k), k)
    if {short(k): v for k, v in per_call.items()} != {"arena_dense_kernel": 1.0,
                                                       "rule_scan_kernel": 1.0}:
        raise SystemExit(f"K6: the profiler shows kernels per call {per_call}, expected one "
                         "arena_dense_kernel (cooperative) and one rule_scan_kernel")
    fplain = cuda_ms(lambda: arena_dense.classify_arena_dense_wire_fused_plain(pool, nw, ntt, **kw),
                     reps=1, warmup=0)
    two_ms, two_s_ms = cuda_ms(two, reps=10), cuda_ms(two_s, reps=10)
    two_plain = cuda_ms(lambda: arena_dense.arena_dense_classify_plain(fields, words, tt, pool,
                                                                       **kw), reps=1, warmup=0)
    bound_ms, bound_by, nbytes, ops, compares, ksteps = dense_bound(
        arena_dense, torchpath, pool, nw, ntt, spec.pages)
    log(f"{tag} K6 arena_dense_fused [{DENSE_TENANTS} tenants x S={DENSE_SLAB} x R={DENSE_SLOTS}, "
        f"B={B}, narrow wire]: grouped {fused_ms:.4f} ms ({B / fused_ms / 1e3:.1f} M packets/s), "
        f"shuffled {fused_s_ms:.4f} ms (shuffled / grouped {fused_s_ms / fused_ms:.3f}); profiler "
        f"device time per call (us): " + ", ".join(f"{short(k)} {v:.2f}"
                                                  for k, v in device_us.items()))
    log(f"{tag} K6 bound: {bound_ms:.4f} ms by {bound_by} ({compares:.4g} row compares of "
        f"{ksteps:.4g} k-steps, {ksteps / max(compares, 1):.3f} a compare, x 2 x 32 int8 ops / "
        f"1,979 TOP/s; {nbytes / 1e6:.2f} MB: wire, tenant, "
        f"results, statistics, the live rows of the slabs reached and the winning rule rows / "
        f"3.35 TB/s); K6 is {fused_ms / bound_ms:.1f}x its bound; plain version {fplain:.4f} ms; "
        f"library call: none (no PyTorch call computes the lookup)")
    log(f"{tag} K6 arena_dense two-column [{B} packets]: grouped {two_ms:.4f} ms, shuffled "
        f"{two_s_ms:.4f} ms; plain version {two_plain:.4f} ms")
    # where the cooperative kernel's time goes: the same pass with every
    # lane "none" (phases 0-3 alone), then on a pool without live rows
    # (with the slab staging), then as is (with the product)
    dead = pool._replace(mask_len=torch.full_like(pool.mask_len, -1))
    coop = []
    for p_, t_ in ((pool, torch.full_like(ntt, -1)), (dead, ntt), (pool, ntt)):
        dev = profiled_kernels(
            lambda p_=p_, t_=t_: arena_dense.classify_arena_dense_wire_fused(p_, nw, t_, **kw),
            reps=3)
        seen = [v for k, v in dev.items() if "arena_dense_kernel" in k]
        coop.append(sum(seen) if seen else None)  # None: the traces lost the kernel
    us = lambda v: "not measured" if v is None else f"{v:.2f}"
    less = lambda a, b: None if a is None or b is None else a - b
    log(f"{tag} K6 cooperative kernel, device us per call: every lane none {us(coop[0])} "
        f"(grouping), no live rows {us(coop[1])} (+ staging {us(less(coop[1], coop[0]))}), as "
        f"is {us(coop[2])} (+ product {us(less(coop[2], coop[1]))})")
    entry = {
        "name": "arena_dense_fused",
        "route": "cuda",
        "source": "infw_torch/kernels/csrc/arena_dense.cu",
        "replaces": "infw/kernels/jaxpath.py:3755",
        "launches": launches["arena_dense_fused"],
        "mismatches": 0,
        "max_abs_err": err,
        "ms": fused_ms,
        "plain_ms": fplain,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "device_ms": sum(device_us.values()) / 1e3 if device_us else None,
        "ms_shuffled": fused_s_ms,
        "cooperative_us": {"grouping": coop[0], "no_live_rows": coop[1], "as_is": coop[2]},
        "row_compares": compares,
        "k_steps": ksteps,
        "two_column": {
            "name": "arena_dense",
            "max_abs_err": err,
            "ms": two_ms,
            "ms_shuffled": two_s_ms,
            "plain_ms": two_plain,
        },
    }
    if "arena_dense_fused" in PARENT_KERNELS:
        fa = lambda: arena_dense.fused_args(pool, nw, ntt, **kw)
        fa_s = lambda: arena_dense.fused_args(pool, snw, sntt, **kw)
        ka = lambda: arena_dense.kernel_args(fields, words, tt, pool, **kw)
        entry["parent_ms"] = parent_turns(tag, "K6 fused, grouped", run,
                                          parent_k6_run("arena_dense_fused", fa))["parent_ms"]
        entry["parent_ms_shuffled"] = parent_turns(
            tag, "K6 fused, shuffled", run_s, parent_k6_run("arena_dense_fused", fa_s))["parent_ms"]
        entry["two_column"]["parent_ms"] = parent_turns(
            tag, "K6 two-column, grouped", two, parent_k6_run("arena_dense", ka))["parent_ms"]
    # the flow phase serves this arena again with a flow table in front
    DENSE_ARENA.update(spec=spec, tabs=tabs, gone=gone, stateless=clf)
    return entry


def overlay_longer_prefixes(compiler, content, t: int):
    """Up to 32 new, longer prefixes inside a tenant's own: each key four
    bits longer (eight past /28), with one Deny catch-all of ruleId
    200 + t % 50; identities the tenant already holds are left out."""
    taken = {k.masked_identity() for k in content}
    out = {}
    for k in content:
        grow = 4 if k.prefix_len - 32 <= 28 else 8
        nk = compiler.LpmKey(k.prefix_len + grow, k.ingress_ifindex, k.ip_data)
        if k.prefix_len - 32 + grow > 128 or nk.masked_identity() in taken:
            continue
        taken.add(nk.masked_identity())
        r = np.zeros((1, 7), np.int32)
        r[0] = [200 + t % 50, 0, 0, 0, 0, 0, 1]
        out[nk] = r
        if len(out) == 32:
            break
    return out


def overlay_phase(tag: str, k6: dict) -> dict:
    """The 512-tenant ctrie arena of the arena phase with a dense overlay
    side-pool of OVERLAY_CAP entries per slab and 16 slots: half the
    tenants get an overlay of new, longer prefixes; a 2^20-packet mixed
    classify launches K3b's two-column entry once and K6's once, and is
    held against the plain composition on every word and the oracle of the
    merged content.  Adds K6's two-column readings to ``k6``; returns the
    launches."""
    import torch

    from infw_torch import arena, compiler, oracle, testing
    from infw_torch.backend.cuda import TorchArenaClassifier
    from infw_torch.kernels import all_kernels, arena_dense, arena_walk, overlay, torchpath
    from infw_torch.packets import concat, narrow_wire

    tabs = [testing.random_tables_fast(np.random.default_rng(9000 + t), n_entries=ARENA_ENTRIES,
                                       width=4, v6_fraction=0.3, ifindexes=(2, 3))
            for t in range(ARENA_TENANTS)]
    spec = arena.arena_spec_for("ctrie", tabs, pages=ARENA_TENANTS + 2, max_tenants=ARENA_TENANTS)
    ov_spec = arena.make_arena_spec("dense", ARENA_TENANTS + 2, ARENA_TENANTS, OVERLAY_CAP,
                                    OVERLAY_SLOTS)
    clf = TorchArenaClassifier(spec, device=DEV, overlay_spec=ov_spec)
    merged = {}
    t0 = time.perf_counter()
    for t, tab in enumerate(tabs):
        clf.load_tenant(t, tab)
        merged[t] = tab
        if t % 2 == 0:
            ov = overlay_longer_prefixes(compiler, tab.content, t)
            clf.load_tenant_overlay(t, compiler.compile_tables_from_content(
                ov, rule_width=OVERLAY_SLOTS))
            merged[t] = compiler.compile_tables_from_content({**tab.content, **ov},
                                                             rule_width=OVERLAY_SLOTS)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ov_alloc = clf.overlay_allocator
    n_ov = [ov_alloc.tables_of(t).num_entries for t in ov_alloc.tenants()]
    log(f"overlay: {ARENA_TENANTS}-tenant ctrie arena + dense side-pool {ov_spec}; "
        f"{len(n_ov)} overlays of {min(n_ov)}-{max(n_ov)} entries; loads {load_s:.2f} s; pools "
        f"{clf.allocator.pool_bytes() / 1e6:.1f} + {ov_alloc.pool_bytes() / 1e6:.1f} MB")
    parts = [testing.random_batch_fast(np.random.default_rng(9500 + t), merged[t],
                                       ARENA_PER_TENANT) for t in range(ARENA_TENANTS)]
    batch = concat(parts)
    tenant = np.repeat(np.arange(ARENA_TENANTS, dtype=np.int32), ARENA_PER_TENANT)
    tenant[::253] = -1
    B = len(batch)
    wire = batch.pack_wire()
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    out, main_ms, _ = timed_device(lambda: clf.classify_async_packed_tenant(wire, tenant).result())
    launches = {k.name: k.launches for k in kernels if k.launches}
    log(f"overlay main path: classify_async_packed_tenant({B}) {main_ms:.2f} ms (first call), "
        f"launches {launches}")
    if launches != {"arena_ctrie_walk": 1, "arena_dense": 1}:
        raise SystemExit("the overlay classify must launch K3b's and K6's two-column entries "
                         "once each and nothing else")
    check_recount(batch, out.results, out.stats_delta, "overlay main path")
    # the whole device pass against the same composition of plain versions
    main, ov = clf.allocator.arena, ov_alloc.arena
    nw = torch.from_numpy(narrow_wire(wire).view(np.int32)).to(DEV)
    tt = torch.from_numpy(tenant).to(DEV)
    okw = {"pages": spec.pages, "ov_pages": ov_spec.pages, "d_max": spec.d_max}

    def plain_pass():
        b = torchpath.unpack_wire(nw)
        f, w = torchpath.packet_fields(b)
        m = arena_walk.arena_ctrie_walk_classify_plain(f, w, tt, main, pages=spec.pages,
                                                       d_max=spec.d_max)
        score_m = overlay.joined_score(main.joined, m[:, 1])
        o = arena_dense.arena_dense_classify_plain(f, w, tt, ov, pages=ov_spec.pages)
        res, _x, st = torchpath.finalize(torch.where(o[:, 1] > score_m, o[:, 0], m[:, 0]), b)
        return torchpath.fuse_wire_outputs(res & 0xFFFF, st)

    run = lambda: arena_dense.classify_arena_overlay_wire(main, ov, nw, tt, **okw)
    check_fused(f"overlay pass [{ARENA_TENANTS} tenants, half with overlays]", run, plain_pass, B)
    ok_lanes = 0
    for t in range(ARENA_TENANTS):
        idx = np.nonzero(tenant == t)[0][:8]
        r = oracle.classify(merged[t], batch.take(idx))
        if not (np.array_equal(out.results[idx], r.results) and np.array_equal(out.xdp[idx], r.xdp)):
            raise SystemExit(f"overlay: tenant {t} disagrees with the oracle of its merged content")
        ok_lanes += len(idx)
    won = int(((out.results >> 8) & 0xFF >= 200).sum())
    log(f"overlay main path: equal to the oracles of the merged content on {ok_lanes} packets; "
        f"{won} verdicts from overlay rules; tenant -1 lanes UNDEF: "
        f"{not out.results[tenant < 0].any()}")
    if out.results[tenant < 0].any() or won == 0:
        raise SystemExit("overlay: no overlay verdicts, or tenant -1 lanes not UNDEF")
    pass_ms = cuda_ms(run, reps=5)
    fields, words = torchpath.packet_fields(torchpath.unpack_wire(nw))
    two = lambda: arena_dense.arena_dense_classify(fields, words, tt, ov, pages=ov_spec.pages)
    two_ms = cuda_ms(two, reps=5)
    two_plain = cuda_ms(lambda: arena_dense.arena_dense_classify_plain(
        fields, words, tt, ov, pages=ov_spec.pages), reps=1, warmup=0)
    k3b_ms = cuda_ms(lambda: arena_walk.arena_ctrie_walk_classify(
        fields, words, tt, main, pages=spec.pages, d_max=spec.d_max), reps=5)
    log(f"{tag} overlay device pass (K3b two-column + K6 two-column + combine, {B} packets): "
        f"{pass_ms:.4f} ms; K6 two-column over the side-pool {two_ms:.4f} ms (plain "
        f"{two_plain:.4f} ms), K3b two-column {k3b_ms:.4f} ms")
    k6["two_column"].update({"launches": launches["arena_dense"], "overlay_ms": two_ms,
                             "overlay_plain_ms": two_plain})
    if "arena_dense" in PARENT_KERNELS:
        ka = lambda: arena_dense.kernel_args(fields, words, tt, ov, pages=ov_spec.pages)
        k6["two_column"]["overlay_parent_ms"] = parent_turns(
            tag, "K6 two-column, side-pool", two, parent_k6_run("arena_dense", ka))["parent_ms"]
    clf.close()
    return launches


# the JAX package's flow ladder on a chip (bench.py bench_flow, on_tpu=True):
# a v6-heavy 200K-entry table of 8 rule slots (the trie path), a 2^17-entry
# 4-way flow table, 2^18 packets in 4096-packet chunks at four shares of
# established traffic
FLOW_TABLE_ENTRIES, FLOW_TABLE_WIDTH, FLOW_SLAB = 200_000, 8, 1 << 17
FLOW_PACKETS, FLOW_CHUNK, FLOW_RUNGS, FLOW_REPS = 1 << 18, 4096, (0.0, 0.5, 0.9, 0.99), 3
# K7 and K8 timed at a ladder chunk, a daemon job (DEFAULT_INGEST_CHUNK)
# and the whole trace
FLOW_SIZES = (FLOW_CHUNK, 1 << 16, FLOW_PACKETS)
# the dense arena's flow table: 2^14 entries per slab, one slab per page
FLOW_ARENA_SLAB, FLOW_ARENA_PER = 1 << 14, 256
# the daemon's flow pass: a 1M-frame file of a 90%-established trace, twice
FLOW_DAEMON_CIDRS, FLOW_DAEMON_FRAMES = 20_000, 1_000_000


def flow_bytes(kind: str, wire_words: int, B: int, ways: int, hits: int = 0,
               inserts: int = 0) -> int:
    """The bytes the flow probe or the flow insert must move for one call,
    whatever kernel computes it (each input read once, each output written
    once): per lane the wire, the tenant and flags (and the verdict), W
    candidate rows (probe: keys 32 + se 8 + vg 8 bytes; insert: keys and
    se), the page and the generation; the probe's 2-byte result, its
    bitmap and counts, the hit lanes' cnt rows read and written and their
    se rows written (read with the candidates); the insert's winners'
    60-byte rows (keys, vg, se, cnt) and counts.  Scratch that a kernel
    keeps between its launches is the kernel's cost, not the function's,
    and is not counted."""
    if kind == "probe":
        return (B * (wire_words * 4 + 8 + ways * 48 + 8 + 2) + -(-B // 32) * 4 + 8
                + hits * (24 + 8))
    return B * (wire_words * 4 + 12 + ways * 40 + 8) + inserts * 60 + 16


@contextlib.contextmanager
def flow_kernels_held(kflow, label: str, seen: dict):
    """While open, every K7 and K8 call is replayed by its plain version on
    a clone of the columns it was given, with the same arguments (the
    probe-time generations, page table and epoch; the same wire, tenants,
    flags and verdicts): the fused buffer or the counts and all four
    columns must be equal after each call.  ``seen`` counts the calls held
    by kernel name.  The replay launches nothing, so the launch counts are
    the kernels' own."""
    import torch

    kernels = {"flow_probe": (kflow.flow_probe, kflow.flow_probe_plain),
               "flow_insert": (kflow.flow_insert, kflow.flow_insert_plain)}

    def held(name, fn, plain):
        def call(table, *args, **kw):
            want = kflow.clone_flow_table(table)
            got = fn(table, *args, **kw)
            ref = plain(want, *args, **kw)
            if not torch.equal(got, ref) or not all(
                    torch.equal(getattr(table, f), getattr(want, f)) for f in kflow.COLUMNS):
                raise SystemExit(f"{label}: {name} call {seen.get(name, 0)} disagrees with its "
                                 f"plain version")
            seen[name] = seen.get(name, 0) + 1
            return got
        return call

    for name, (fn, plain) in kernels.items():
        setattr(kflow, name, held(name, fn, plain))
    try:
        yield
    finally:
        for name, (fn, _plain) in kernels.items():
            setattr(kflow, name, fn)


def flow_parent_turns(tag: str, label: str, kflow, table, call) -> dict:
    """--parent's K7 or K8 against this tree's through the same wrapper,
    each on a clone of ``table``: the output and the four columns equal
    after one call, then the times with the host ahead of the card, in
    turns (parent, this, this, parent).  Returns {"ms": this tree's
    mean, "parent_ms": the parent's}."""
    import torch

    mine, theirs = kflow.clone_flow_table(table), kflow.clone_flow_table(table)

    def parent_fn():
        with parent_flow(kflow):
            return call(theirs)

    a, b = call(mine), parent_fn()
    torch.cuda.synchronize()
    if not torch.equal(a, b) or not all(torch.equal(getattr(mine, f), getattr(theirs, f))
                                        for f in kflow.COLUMNS):
        raise SystemExit(f"--parent's kernel disagrees with this tree's [{label}]")
    this_fn = lambda: call(mine)  # noqa: E731
    p1, t1, t2, p2 = (device_paced_ms(fn) for fn in (parent_fn, this_fn, this_fn, parent_fn))
    log(f"{tag} parent vs this tree [{label}], device-paced in turns: parent {p1:.5f}, {p2:.5f} "
        f"ms; this {t1:.5f}, {t2:.5f} ms; this / parent {(t1 + t2) / (p1 + p2):.3f}")
    return {"ms": (t1 + t2) / 2, "parent_ms": (p1 + p2) / 2}


#: what the flow phase hands to the resident phase: the ladder's tables,
#: traces and rungs, and the daemon pass's NodeState, frames and the
#: stateless daemon's verdict file
FLOW_STASH: dict = {}


def flow_phase(tag: str) -> tuple:
    """The stateful flow tier (ROADMAP item 9) at the JAX package's flow
    bench shape: per rung of established traffic, every chunk's verdicts
    against the stateless classifier on the same tables before any timing,
    then packets/s of the flow pass (from a cold table) and of the
    stateless pass in turns, the measured hit rate and the launches of
    K7, K8 and K2 per pass; K7 and K8 against their plain versions chunk by
    chunk over the 90% trace on both wires (fused buffers, counts, all
    four columns); their times at B = 4096, 65536 and 2^18 beside their
    bounds and plain versions (and --parent's, in turns); the eviction
    storm; the dense arena of PERF.md section 4 with
    a flow table, against its stateless classify (K6 serves the misses),
    K7 and K8 held there against their plain versions;
    and the daemon with --flow-table over a 1M-frame file read twice,
    against a stateless daemon, flow_* on /metrics against the
    classifier's counters.  Returns the kernels-line entries of K7 and
    K8."""
    import shutil

    import torch

    from infw_torch import compiler, daemon, spec as spec_mod, testing
    from infw_torch.backend.cuda import TorchArenaClassifier, TorchClassifier
    from infw_torch.flow import FlowConfig, host_unpack_wire
    from infw_torch.interfaces import Interface, InterfaceRegistry
    from infw_torch.kernels import all_kernels, flow as kflow
    from infw_torch.obs import pcap

    kernels = all_kernels()
    t0 = time.perf_counter()
    tables = testing.random_tables_fast(np.random.default_rng(77), FLOW_TABLE_ENTRIES,
                                        width=FLOW_TABLE_WIDTH, v6_fraction=0.8, ifindexes=(2, 3))
    cfg = FlowConfig.make(entries=FLOW_SLAB)
    clf = TorchClassifier(device=DEV, flow_table=cfg)
    base = TorchClassifier(device=DEV)
    clf.load_tables(tables)
    base.load_tables(tables)
    if (clf.active_path, base.active_path) != ("trie", "trie"):
        raise SystemExit(f"flow phase: paths {clf.active_path}, {base.active_path}; expected trie")
    warm = clf.flow.warm([FLOW_CHUNK])
    torch.cuda.synchronize()
    log(f"flow: {tables.num_entries} entries x {tables.rule_width} rule slots (trie path), flow "
        f"table {cfg.capacity} rows x {cfg.ways} ways "
        f"({sum(t.numel() * 4 for t in clf.flow._flow) / 1e6:.1f} MB with K8's scratch), "
        f"{warm} warm launches; set up in {time.perf_counter() - t0:.2f} s")

    def run_pass(c, batch):
        return [c.classify(batch.slice(lo, lo + FLOW_CHUNK), apply_stats=False)
                for lo in range(0, len(batch), FLOW_CHUNK)]

    def check(outs, want, label):
        for k, (o, w) in enumerate(zip(outs, want)):
            if not (np.array_equal(o.results, w.results) and np.array_equal(o.xdp, w.xdp)
                    and np.array_equal(o.stats_delta, w.stats_delta)):
                raise SystemExit(f"flow {label}: chunk {k} disagrees with the stateless path")

    def flow_pass(c, batch):
        c.flow.reset()
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        s0 = c.flow.stats.values()
        t = time.perf_counter()
        run_pass(c, batch)
        dt = time.perf_counter() - t
        s1 = c.flow.stats.values()
        return dt, (s1["hits"] - s0["hits"]) / len(batch), {k.name: k.launches for k in kernels
                                                              if k.launches}

    def base_pass(batch):
        t = time.perf_counter()
        run_pass(base, batch)
        return time.perf_counter() - t

    traces, ladder = {}, {}
    FLOW_STASH.update(tables=tables, traces=traces, ladder=ladder)
    for ef in FLOW_RUNGS:
        pct = int(ef * 100)
        batch, meta = testing.flow_trace_batch(np.random.default_rng(7700 + pct), tables,
                                               FLOW_PACKETS, ef, chunk_packets=FLOW_CHUNK)
        traces[pct] = (batch, meta)
        clf.flow.reset()
        check(run_pass(clf, batch), run_pass(base, batch), f"{pct}%")
        flow_pass(clf, batch)  # warm, off the clock
        base_pass(batch)
        flow_s, base_s, hit_rate, launches = float("inf"), float("inf"), 0.0, {}
        for _ in range(FLOW_REPS):  # in turns, min against min
            dt, hr, ln = flow_pass(clf, batch)
            if dt < flow_s:
                flow_s, hit_rate, launches = dt, hr, ln
            base_s = min(base_s, base_pass(batch))
        if launches.get("flow_probe", 0) <= 0 or launches.get("flow_insert", 0) <= 0:
            raise SystemExit(f"flow {pct}%: the flow pass launched {launches}")
        ladder[pct] = {"flow_pps": FLOW_PACKETS / flow_s, "stateless_pps": FLOW_PACKETS / base_s,
                       "hit_rate": hit_rate, "launches": launches}
        log(f"{tag} flow ladder {pct}% established: {FLOW_PACKETS / flow_s / 1e6:.3f} M packets/s "
            f"flow (measured hit rate {hit_rate:.4f}, {meta['n_flows']} flows) against "
            f"{FLOW_PACKETS / base_s / 1e6:.3f} M packets/s stateless ({base_s / flow_s:.3f}x); "
            f"launches per flow pass {launches} ({FLOW_PACKETS // FLOW_CHUNK} chunks); verdicts "
            f"of every chunk equal to the stateless path's")

    # K7 and K8 against their plain versions, chunk by chunk over the 90%
    # trace, as the classifier drives them (the misses compacted): on the
    # 7-word wire, then on the 4-word wire of the trace's IPv4 form (IP
    # words 1-3 zeroed); the tables this leaves are the timings' state
    batch, _meta = traces[90]
    v4 = batch.take(np.arange(len(batch)))
    v4.kind[:] = 1
    v4.ip_words[:, 1:] = 0
    dev = torch.device(DEV)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)  # noqa: E731
    pack = lambda b, width: b.pack_wire() if width == 7 else b.pack_wire_v4()  # noqa: E731
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    geo = {"slab_entries": cfg.entries, "ways": cfg.ways}
    warm = {}
    for width, trace in ((7, batch), (4, v4)):
        ref = run_pass(base, trace)
        got = kflow.empty_flow_table(cfg.capacity, dev)
        want = kflow.clone_flow_table(got)
        n_chunks = 0
        for k, lo in enumerate(range(0, len(trace), FLOW_CHUNK)):
            sub = trace.slice(lo, lo + FLOW_CHUNK)
            wire_np = pack(sub, width)
            wire, fl = put(wire_np), put(sub.tcp_flags.astype(np.int32))
            zt = torch.zeros(len(sub), dtype=torch.int32, device=dev)
            fused = kflow.flow_probe(got, one, one, wire, zt, fl, k + 1, cfg.max_age, **geo)
            pf = kflow.flow_probe_plain(want, one, one, wire, zt, fl, k + 1, cfg.max_age, **geo)
            if not torch.equal(fused, pf):
                raise SystemExit(f"K7: chunk {k} of the 90% trace ({width}-word wire) disagrees "
                                 f"with its plain version")
            hit = kflow.split_flow_probe_outputs(fused.cpu().numpy(), len(sub))[1]
            miss = np.nonzero(~hit)[0]
            mw = put(wire_np[miss])
            mt = torch.zeros(len(miss), dtype=torch.int32, device=dev)
            mf = put(sub.tcp_flags[miss].astype(np.int32))
            mv = put((ref[k].results[miss] & 0xFFFF).astype(np.int32))
            c1 = kflow.flow_insert(got, one, one, mw, mt, mf, mv, k + 1, **geo)
            c2 = kflow.flow_insert_plain(want, one, one, mw, mt, mf, mv, k + 1, **geo)
            if not torch.equal(c1, c2) or not all(torch.equal(getattr(got, f), getattr(want, f))
                                                  for f in kflow.COLUMNS):
                raise SystemExit(f"K8: chunk {k} of the 90% trace ({width}-word wire) disagrees "
                                 f"with its plain version")
            n_chunks += 1
        torch.cuda.synchronize()
        if not bool((got.winner == -1).all()):
            raise SystemExit(f"K8 left its winner scratch dirty ({width}-word wire)")
        log(f"K7 and K8 against their plain versions over the 90% trace, {width}-word wire: "
            f"{n_chunks} chunks, fused buffers, counts and the four columns equal after every "
            f"chunk ({int((got.se[:, 0] > 0).sum())} live entries at the end)")
        warm[width] = (trace, got)
        del want

    # times at B = 4096 (a ladder chunk), 65536 (a daemon job) and 2^18 (the
    # trace as one batch) on both wires, each on a copy of the warm table
    timing = {}
    for (width, (trace, got)), B in ((w, B) for w in warm.items() for B in FLOW_SIZES):
        sub = trace.slice(len(trace) // 2, len(trace) // 2 + B) if B < len(trace) else trace
        wire_np = pack(sub, width)
        wire, fl = put(wire_np), put(sub.tcp_flags.astype(np.int32))
        zt = torch.zeros(len(sub), dtype=torch.int32, device=dev)
        verdict = put(np.random.default_rng(B).integers(0, 1 << 16, len(sub)).astype(np.int32))
        calls = {
            "k7": lambda t: kflow.flow_probe(t, one, one, wire, zt, fl, 999, cfg.max_age, **geo),
            "k8": lambda t: kflow.flow_insert(t, one, one, wire, zt, fl, verdict, 999, **geo),
        }
        plains = {
            "k7": lambda t: kflow.flow_probe_plain(t, one, one, wire, zt, fl, 999, cfg.max_age,
                                                   **geo),
            "k8": lambda t: kflow.flow_insert_plain(t, one, one, wire, zt, fl, verdict, 999,
                                                    **geo),
        }
        hits = kflow.split_flow_probe_outputs(
            calls["k7"](kflow.clone_flow_table(got)).cpu().numpy(), B)[2]
        inserts = int(calls["k8"](kflow.clone_flow_table(got))[0])
        f = host_unpack_wire(wire_np)
        rst = (f["proto"] == 6) & ((sub.tcp_flags & 0x04) != 0)
        elig = int((((f["kind"] == 1) | (f["kind"] == 2)) & (f["l4_ok"] != 0) & ~rst).sum())
        bounds = {"k7": flow_bytes("probe", width, B, cfg.ways, hits=hits),
                  "k8": flow_bytes("insert", width, B, cfg.ways, inserts=inserts)}
        row = {}
        for key, call in calls.items():
            tbl, ptbl = kflow.clone_flow_table(got), kflow.clone_flow_table(got)
            run = lambda: call(tbl)  # noqa: E731
            counts, fills = {}, {}
            dev_us = profiled_kernels(run, 20, counts, fills)
            if dev_us and (sum(counts.values()) != 1 or fills):
                raise SystemExit(f"{key}: {counts} kernels and {fills} memsets a call at B={B}; "
                                 f"expected one kernel and no memset")
            row[key] = {
                "ms": cuda_ms(run, reps=50 if B == FLOW_CHUNK else 10),
                "device_paced_ms": device_paced_ms(run),
                "device_ms": sum(dev_us.values()) / 1e3 if dev_us else None,
                "host_us": host_ms_per_call(run, 200) * 1e3,
                "bound_ms": bounds[key] / HBM_BYTES_PER_S * 1e3,
                "plain_ms": cuda_ms(lambda: plains[key](ptbl), reps=3, warmup=1),
                "parent_in_turns": None,
            }
            if "flow_probe" in PARENT_KERNELS:
                row[key]["parent_in_turns"] = flow_parent_turns(
                    tag, f"{'K7' if key == 'k7' else 'K8'}, B={B}, {width}-word wire", kflow,
                    got, call)
            del tbl, ptbl
        timing[(width, B)] = row
        for key, name, extra in (("k7", "K7 flow_probe", f"{hits} hits"),
                                 ("k8", "K8 flow_insert", f"{inserts} inserts of {elig} eligible "
                                                          f"lanes")):
            r = row[key]
            dv = "not measured" if r["device_ms"] is None else f"{r['device_ms'] * 1e3:.2f} us"
            log(f"{tag} {name} at B={B}, {width}-word wire: device {dv} a call (profiler, one "
                f"kernel, no memset), {r['device_paced_ms']:.5f} ms a call with the host ahead, "
                f"{r['ms']:.5f} ms a call in a loop (CUDA events), host {r['host_us']:.2f} us a "
                f"call; bound {r['bound_ms']:.5f} ms by bytes ({extra}); plain version "
                f"{r['plain_ms']:.4f} ms")

    # the eviction storm: the 90% trace against a table 8x smaller than
    # its flow population
    batch, meta = testing.flow_trace_batch(np.random.default_rng(7790), tables, FLOW_PACKETS, 0.9,
                                           chunk_packets=FLOW_CHUNK)
    small = FlowConfig.make(entries=max(meta["n_flows"] // 8, 64))
    sclf = TorchClassifier(device=DEV, flow_table=small)
    sclf.load_tables(tables)
    check(run_pass(sclf, batch), run_pass(base, batch), "eviction storm")
    dt, hr, ln = flow_pass(sclf, batch)
    v = sclf.flow.stats.values()
    log(f"{tag} flow eviction storm ({small.capacity} slots, {meta['n_flows']} flows): "
        f"{FLOW_PACKETS / dt / 1e6:.3f} M packets/s, {v['evictions']} evictions in the pass, hit "
        f"rate {hr:.4f}, launches {ln}; verdicts equal to the stateless path's")
    sclf.close()
    clf.close()
    base.close()

    # the dense arena of dense_arena_phase with a flow table: K6 serves the
    # misses
    arena_spec, tabs, gone = DENSE_ARENA["spec"], DENSE_ARENA["tabs"], DENSE_ARENA["gone"]
    stateless = DENSE_ARENA["stateless"]
    t0 = time.perf_counter()
    fclf = TorchArenaClassifier(arena_spec, device=DEV, flow_table=FLOW_ARENA_SLAB)
    for t, tab in enumerate(tabs):
        fclf.load_tenant(t, tab)
    fclf.destroy_tenant(gone)
    parts, tags = [], []
    for t, tab in enumerate(tabs):
        b, _m = testing.flow_trace_batch(np.random.default_rng(7600 + t), tab, FLOW_ARENA_PER, 0.5,
                                         chunk_packets=FLOW_ARENA_PER // 2)
        parts.append(b)
        tags.append(np.full(FLOW_ARENA_PER, t, np.int32))
    from infw_torch.packets import concat
    mixed = concat(parts)
    tenant = np.concatenate(tags)
    tenant[::509] = -1
    wire_np = mixed.pack_wire()
    log(f"flow dense arena: {fclf.flow.config.capacity} flow rows ({fclf.flow.config.pages} slabs "
        f"of {fclf.flow.config.entries}), {len(tabs)} tenants loaded in "
        f"{time.perf_counter() - t0:.2f} s; {len(mixed)} packets")
    arena_launches, held = [], {}
    for rnd in range(2):
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        # K7 and K8 replayed by their plain versions at this shape: 514
        # page-steered slabs, generations bumped by load and destroy,
        # tenant -1 lanes
        with flow_kernels_held(kflow, f"flow dense arena classify {rnd}", held):
            out = fclf.classify_async_packed_tenant(wire_np, tenant,
                                                    tcp_flags=mixed.tcp_flags).result()
        arena_launches.append({k.name: k.launches for k in kernels if k.launches})
        ref = stateless.classify_async_packed_tenant(wire_np, tenant).result()
        if not (np.array_equal(out.results, ref.results) and np.array_equal(out.xdp, ref.xdp)
                and np.array_equal(out.stats_delta, ref.stats_delta)):
            raise SystemExit(f"flow dense arena: classify {rnd} disagrees with the stateless arena")
    if held.get("flow_probe", 0) != 2 or held.get("flow_insert", 0) != 2:
        raise SystemExit(f"flow dense arena: K7 and K8 held {held} times; expected 2 each")
    fc = fclf.flow_counters()
    if arena_launches[0].get("arena_dense_fused", 0) <= 0 or \
            arena_launches[0].get("flow_probe", 0) <= 0 or fc["flow_hits_total"] <= 0:
        raise SystemExit(f"flow dense arena: launches {arena_launches}, counters {fc}")
    log(f"flow dense arena: two mixed classifies equal to the stateless arena's, K7 and K8 "
        f"equal to their plain versions in both (fused buffers, counts, four columns); launches "
        f"{arena_launches}; hits {fc['flow_hits_total']}, inserts {fc['flow_inserts_total']}, "
        f"occupancy {fc['flow_occupancy']}")
    fclf.close()

    # the daemon with --flow-table over a 1M-frame file read twice, against
    # a stateless daemon
    registry = InterfaceRegistry()
    for name, index in DAEMON_IFACES.items():
        registry.add(Interface(name=name, index=index))
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "flow-smoke")
    shutil.rmtree(root, ignore_errors=True)
    doc = testing.random_nodestate(np.random.default_rng(41), DAEMON_NODE, DAEMON_IFACES,
                                   FLOW_DAEMON_CIDRS, width=FLOW_TABLE_WIDTH)
    ns = spec_mod.IngressNodeFirewallNodeState.from_dict(doc)
    dtables = compiler.compile_tables(ns.spec.interface_ingress_rules, registry)
    trace, tmeta = testing.flow_trace_batch(np.random.default_rng(7800), dtables,
                                            FLOW_DAEMON_FRAMES, 0.9, chunk_packets=1 << 16)
    fb = pcap.build_frames_bulk(trace.kind, trace.ip_words, trace.proto, trace.dst_port,
                                trace.icmp_type, trace.icmp_code, l4_ok=trace.l4_ok)
    fb.ifindex = np.asarray(trace.ifindex, np.uint32)
    outs = {}
    daemon_launches = {}
    for name, table in (("stateless", None), ("flow", FlowConfig.make(entries=FLOW_SLAB))):
        d = daemon.Daemon(state_dir=os.path.join(root, name), node_name=DAEMON_NODE,
                          registry=registry, metrics_port=0, health_port=0, poll_period_s=0.1,
                          file_poll_interval_s=0.02, flow_table=table,
                          backend="cuda" if DEV == "cuda" else "cpu")
        try:
            d.start()
            p = os.path.join(d.nodestates_dir, f"{DAEMON_NODE}.json")
            with open(p + ".tmp", "w") as f:
                json.dump(doc, f)
            os.replace(p + ".tmp", p)
            _wait(lambda: d.syncer.classifier is not None
                  and d.syncer.classifier.tables is not None
                  and bool(d.syncer.attached_interfaces()), f"the {name} daemon's NodeState", 300)
            c = d.syncer.classifier
            for rnd in range(2 if table is not None else 1):
                fn = f"{rnd}.frames"
                stage = os.path.join(d.state_dir, "staging")
                os.makedirs(stage, exist_ok=True)
                daemon.write_frames_file_v2(os.path.join(stage, fn), fb)
                torch.cuda.synchronize()
                for k in kernels:
                    k.launches = 0
                t = time.perf_counter()
                os.replace(os.path.join(stage, fn), os.path.join(d.ingest_dir, fn))
                _wait(lambda: os.path.exists(os.path.join(d.out_dir, fn + ".verdicts.json")),
                      f"the {name} daemon's pass {rnd}", 600, 0.002)
                dt = time.perf_counter() - t
                ln = {k.name: k.launches for k in kernels if k.launches}
                daemon_launches[f"{name} {rnd}"] = ln
                outs[f"{name} {rnd}"] = open(os.path.join(d.out_dir, fn + ".verdicts.bin"),
                                             "rb").read()
                log(f"{tag} flow daemon ({name}, pass {rnd}): {len(fb)} frames in {dt:.3f} s = "
                    f"{len(fb) / dt / 1e6:.3f} M packets/s, launches {ln}; path "
                    f"{c.active_path}")
            if table is not None:
                fc = c.flow_counters()
                for key in ("flow_hits_total", "flow_misses_total", "flow_inserts_total",
                            "flow_evictions_total", "flow_invalidations_total", "flow_occupancy"):
                    if _metric(d, key) != fc[key]:
                        raise SystemExit(f"flow daemon: /metrics {key} {_metric(d, key)} is not "
                                         f"the classifier's {fc[key]}")
                if (fc["flow_hits_total"] <= 0
                        or daemon_launches["flow 1"].get("flow_probe", 0) <= 0):
                    raise SystemExit(f"flow daemon: counters {fc}, launches {daemon_launches}")
                log(f"flow daemon: flow_* on /metrics equal the classifier's counters {fc}")
        finally:
            d.stop()
    if not outs["flow 0"] == outs["flow 1"] == outs["stateless 0"]:
        raise SystemExit("flow daemon: its verdict files differ from the stateless daemon's")
    FLOW_STASH.update(daemon_doc=doc, daemon_fb=fb, daemon_registry=registry,
                      daemon_tables=dtables, daemon_stateless=outs["stateless 0"])
    log(f"flow daemon: both passes' verdict files equal the stateless daemon's "
        f"({tmeta['n_flows']} flows in {len(fb)} frames)")
    shutil.rmtree(root, ignore_errors=True)

    common = {"route": "cuda", "source": "infw_torch/kernels/csrc/flow_table.cu",
              "max_abs_err": 0, "mismatches": 0, "bound_by": "bytes", "library_ms": None}

    def entry(key, name, replaces):
        head = timing[(7, FLOW_CHUNK)][key]
        return {"name": name, **common, "replaces": replaces,
                "launches": ladder[90]["launches"][name],
                **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "device_ms",
                                        "device_paced_ms", "host_us", "parent_in_turns")},
                "sizes": {f"{w}-word": {str(B): timing[(w, B)][key] for B in FLOW_SIZES}
                          for w in (7, 4)},
                "arena_launches": arena_launches[0].get(name, 0)}

    k7 = {**entry("k7", "flow_probe", "infw/kernels/jaxpath.py:6014"), "ladder": ladder}
    k8 = entry("k8", "flow_insert", "infw/kernels/jaxpath.py:6065")
    for k in (k7, k8):
        k["flow_daemon_launches"] = {p: c.get(k["name"], 0) for p, c in daemon_launches.items()}
    return k7, k8


# the resident step (ROADMAP item 10): bench_resident's shape (bench.py
# bench_resident, on_tpu: a 100K-entry table of 8 rule slots, half IPv6, a
# 2^17-entry 4-way flow table, admissions of 32 and 128 packets of a
# 90%-established trace, 100 of each), the flow ladder's (the flow phase's
# tables and traces), the superbatch at bench_pipeline's (K = 4, the 100K
# table, a 2^14-entry flow table), the warmed steady state and the daemon
RESIDENT_ENTRIES, RESIDENT_BATCHES, RESIDENT_CHUNKS, RESIDENT_REPS = 100_000, (32, 128), 100, 3
SUPER_K, SUPER_SLAB, SUPER_BATCHES = 4, 1 << 14, (32, 128)
STEADY_DISPATCHES = 1000
# serving while rules change: a rules-only edit of EDIT_KEYS keys loaded
# before every EDIT_EVERY-th admission of bench_resident's 128-packet trace
# (the classifier), and an edit file of EDIT_KEYS rules edits landing every
# EDIT_FILE_S seconds while the daemons read the 1M-frame file
EDIT_KEYS, EDIT_EVERY, EDIT_FILE_S = 4, 8, 0.05


def resident_insert_bytes(width: int, B: int, ways: int, hits: int, inserts: int) -> int:
    """K8's resident entry: the hit bitmap of every lane; for each lane that
    missed (the only eligible ones) the wire, tenant and flags, W candidate
    rows (keys and se), the page and generation, the 2-byte packed verdict
    and the 2-byte merged result written; the winners' 60-byte rows, the
    counts, and the device epoch read and written.  A lane that hit needs
    only its bit."""
    misses = B - hits
    return (misses * (width * 4 + 8 + ways * 40 + 8 + 2 + 2) + -(-B // 32) * 4
            + inserts * 60 + 16 + 8)


def resident_edit_passes(tag: str, tables, chunks, res, multi, base, admit, same) -> dict:
    """Serving while rules change, on the classifier: from an
    IncrementalTables of ``tables``' content, a rules-only edit of
    EDIT_KEYS keys loaded with its dirty hint (as the daemon's edit flush
    loads it) before every EDIT_EVERY-th admission of ``chunks``.  Four
    passes in turns, twice, each from a cold flow table: the resident
    classifier as it is (a generation of the same layout keeps its graphs),
    the same with every generation retiring its graphs (the pool's
    ``same_layout`` answering False: the behavior before graphs were kept),
    the multi-dispatch flow plan and the stateless classifier.  Every
    admission equals the stateless one's.  Returns per pass the p50 and
    mean admission, the loads' mean, packets/s over admissions and loads,
    and the captures."""
    import torch

    from infw_torch import compiler
    from infw_torch import resident as resident_mod
    from infw_torch import testing

    t0 = time.perf_counter()
    inc = compiler.IncrementalTables.from_content(dict(tables.content),
                                                  rule_width=tables.rule_width)
    gens = [(inc.snapshot(), None)]
    inc.clear_dirty()
    rng = np.random.default_rng(8816)
    keys = list(tables.content)
    for _ in range(1, len(chunks) // EDIT_EVERY):
        picks = rng.choice(len(keys), size=EDIT_KEYS, replace=False)
        inc.apply({keys[int(i)]: testing.random_rules(rng, tables.rule_width) for i in picks})
        gens.append((inc.snapshot(), inc.peek_dirty()))
        inc.clear_dirty()
    log(f"resident edits: {len(gens) - 1} rules-only generations of {EDIT_KEYS} keys made in "
        f"{time.perf_counter() - t0:.2f} s")

    def edit_pass(c):
        flows = chunks if c.flow is not None else [ch[:2] + (None,) for ch in chunks]
        c.load_tables(gens[0][0])
        for chunk in flows[:2]:  # both slots on the first generation
            admit(c, chunk)
        if c.flow is not None:
            c.flow.reset()
        allocs0 = c.resident_counters()["resident_allocs_total"] if c.resident else 0
        torch.cuda.synchronize()
        times, loads, outs = [], [], []
        for k, chunk in enumerate(flows):
            if k and k % EDIT_EVERY == 0 and k // EDIT_EVERY < len(gens):
                t = time.perf_counter()
                snap, hint = gens[k // EDIT_EVERY]
                c.load_tables(snap, dirty_hint=hint)
                loads.append(time.perf_counter() - t)
            t = time.perf_counter()
            outs.append(admit(c, chunk))
            times.append(time.perf_counter() - t)
        total = sum(times) + sum(loads)
        # one alloc is each generation's context; the rest are captures
        captures = (c.resident_counters()["resident_allocs_total"] - allocs0 - len(loads)
                    if c.resident else 0)
        return outs, {"p50_us": float(np.median(times)) * 1e6,
                      "mean_us": float(np.mean(times)) * 1e6,
                      "load_mean_us": float(np.mean(loads)) * 1e6, "loads": len(loads),
                      "pps": len(chunks) * len(chunks[0][0]) / total, "captures": captures}

    def retiring(c):
        keep = resident_mod.same_layout
        resident_mod.same_layout = lambda a, b: False
        try:
            return edit_pass(c)
        finally:
            resident_mod.same_layout = keep

    runs = (("kept", lambda: edit_pass(res)), ("retiring", lambda: retiring(res)),
            ("multi", lambda: edit_pass(multi)), ("stateless", lambda: edit_pass(base)))
    best = {}
    for _rep in range(2):
        outs = {}
        for name, run in runs:
            outs[name], r = run()
            if name not in best or r["pps"] > best[name]["pps"]:
                best[name] = r
        for name in ("kept", "retiring", "multi"):
            for k, (a, b) in enumerate(zip(outs[name], outs["stateless"])):
                if not same(a, b):
                    raise SystemExit(f"resident edits ({name}): admission {k} differs from the "
                                     f"stateless classifier's")
    if best["kept"]["captures"] != 0:
        raise SystemExit(f"resident edits: a rules-only generation captured again {best}")
    for name, r in best.items():
        log(f"{tag} resident edits ({name}): {len(chunks)} admissions of {len(chunks[0][0])}, "
            f"{r['loads']} rules-only loads: p50 {r['p50_us']:.1f} us, mean {r['mean_us']:.1f} "
            f"us an admission, load {r['load_mean_us']:.1f} us, {r['pps'] / 1e6:.4f} M packets/s "
            f"over admissions and loads, {r['captures']} captures (the better of 2 passes in "
            f"turns, each from a cold table); every admission equal to the stateless one")
    return best


def daemon_edit_pass(tag: str, d, fb, label: str) -> dict:
    """The daemon ``d`` (NodeState loaded) reads ``fb`` once without edits
    and once while an edit file of EDIT_KEYS rules-only edits lands every
    EDIT_FILE_S seconds: the seconds of each pass, the edit flushes, and
    the resident pool's allocations (contexts and captures) during the
    edit pass.  Each verdict file must hold one verdict a frame (the
    verdicts of an edited pass are each the before's or the after's and
    are not compared here: the classifier's edit passes hold them)."""
    import threading

    from infw_torch import daemon, testing, txn

    c = d.syncer.classifier
    keys = list(c.tables.content)
    width = c.tables.rule_width
    rng = np.random.default_rng(8817)
    out = {}
    for name in ("plain", "edits"):
        fn = f"{label}-{name}.frames"
        stage = os.path.join(d.state_dir, "staging")
        os.makedirs(stage, exist_ok=True)
        daemon.write_frames_file_v2(os.path.join(stage, fn), fb)
        before = d.txn_stats.snapshot()
        allocs0 = c.resident_counters().get("resident_allocs_total", 0)
        done = threading.Event()
        landed = [0]

        def land():
            estage = os.path.join(d.state_dir, "edit-staging")
            os.makedirs(estage, exist_ok=True)
            while True:
                picks = rng.choice(len(keys), size=EDIT_KEYS, replace=False)
                ops = [txn.EditOp("rules_edit", keys[int(i)], testing.random_rules(rng, width))
                       for i in picks]
                e = f"{label}-{landed[0]:04d}.json"
                txn.write_edit_file(os.path.join(estage, e), ops)
                os.replace(os.path.join(estage, e), os.path.join(d.edits_dir, e))
                landed[0] += 1
                if done.wait(EDIT_FILE_S):
                    return

        lander = threading.Thread(target=land) if name == "edits" else None
        t = time.perf_counter()
        os.replace(os.path.join(stage, fn), os.path.join(d.ingest_dir, fn))
        if lander is not None:
            lander.start()
        try:
            _wait(lambda: os.path.exists(os.path.join(d.out_dir, fn + ".verdicts.json")),
                  f"the {label} daemon's {name} pass", 600, 0.002)
            dt = time.perf_counter() - t
        finally:
            done.set()
            if lander is not None:
                lander.join()
        n = os.path.getsize(os.path.join(d.out_dir, fn + ".verdicts.bin")) // 4
        if n != len(fb):
            raise SystemExit(f"{label} daemon {name} pass: {n} verdicts for {len(fb)} frames")
        flushed_in_pass = d.txn_stats.snapshot()["txns"] - before["txns"]
        _wait(lambda: not os.listdir(d.edits_dir) and not (
            d._edit_flush_thread is not None and d._edit_flush_thread.is_alive()),
            f"the {label} daemon's edits/ to drain", 60)
        flushes = d.txn_stats.snapshot()["txns"] - before["txns"]
        allocs = c.resident_counters().get("resident_allocs_total", 0) - allocs0
        if name == "edits" and flushes <= 0:
            raise SystemExit(f"{label} daemon: no edit flushed during the edit pass")
        out[name] = {"s": dt, "pps": len(fb) / dt, "files": landed[0], "flushes": flushes,
                     "flushes_in_pass": flushed_in_pass, "resident_allocs": allocs}
        log(f"{tag} {label} daemon, {name} pass: {len(fb)} frames in {dt:.3f} s = "
            f"{len(fb) / dt / 1e6:.3f} M packets/s; {landed[0]} edit files landed, {flushes} "
            f"flushes ({flushed_in_pass} before the pass ended), {allocs} resident allocations "
            f"(a context a flush, the rest captures)")
    return out


def admission_profile(fn, reps: int = 10) -> dict:
    """torch.profiler over ``reps`` calls of ``fn`` after a warm one:
    kernels, memsets, host-to-device and device-to-host copies per call,
    and the kernels' device microseconds per call.  Eight short spin
    kernels precede the calls and eight follow them inside the recorded
    window: a trace that drops its first or last events (as traces taken
    after the resident graphs did) drops some of those, and is taken
    again, up to five times (then nothing is measured: every value
    None)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _attempt in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            for _ in range(8):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        out = {"kernels": 0.0, "memsets": 0.0, "h2d": 0.0, "d2h": 0.0, "device_us": 0.0}
        spins = 0
        for e in prof.events():
            if e.device_type != DeviceType.CUDA or e.is_user_annotation:
                continue
            if "spin_kernel" in e.name:
                spins += 1
            elif e.name.startswith("Memset"):
                out["memsets"] += 1 / reps
            elif "HtoD" in e.name:
                out["h2d"] += 1 / reps
            elif "DtoH" in e.name:
                out["d2h"] += 1 / reps
            elif not e.name.startswith("Memcpy"):
                out["kernels"] += 1 / reps
                out["device_us"] += e.time_range.elapsed_us() / reps
        if spins == 16:
            return {k: round(v, 6) for k, v in out.items()}
    return dict.fromkeys(out)


def resident_profile_child() -> None:
    """Run in a fresh process by the resident phase: one resident admission
    of the flow ladder's 90% trace (its 4096-packet chunk at the middle of
    the trace, on the table the trace before it filled) under
    admission_profile, printed as one JSON line.  A trace of graph replays
    taken in a process whose earlier profiler sessions traced other work
    loses events (PR 16), so this count runs where the trace is the
    process's first."""
    from infw_torch import layout, testing
    from infw_torch.backend.cuda import TorchClassifier
    from infw_torch.flow import FlowConfig

    tables = testing.random_tables_fast(np.random.default_rng(77), FLOW_TABLE_ENTRIES,
                                        width=FLOW_TABLE_WIDTH, v6_fraction=0.8, ifindexes=(2, 3))
    batch, _meta = testing.flow_trace_batch(np.random.default_rng(7790), tables, FLOW_PACKETS, 0.9,
                                            chunk_packets=FLOW_CHUNK)
    layout.build_poptrie(tables)  # the trie path's host layout, memoized for the loads
    wait_for_go()
    clf = TorchClassifier(device=DEV, flow_table=FlowConfig.make(entries=FLOW_SLAB), resident=True)
    clf.load_tables(tables)
    half = len(batch) // 2
    for lo in range(0, half, FLOW_CHUNK):
        clf.classify(batch.slice(lo, lo + FLOW_CHUNK), apply_stats=False)
    sub = batch.slice(half, half + FLOW_CHUNK)
    print(json.dumps(admission_profile(lambda: clf.classify(sub, apply_stats=False))), flush=True)


def resident_phase(tag: str, k7: dict, k8: dict) -> None:
    """The resident step (ROADMAP item 10), the kernels line's ``resident``
    readings of K7 and K8 (their resident entries) added to ``k7`` and
    ``k8``:

    1. bench_resident's shape: every admission's results, verdicts and
       statistics against the multi-dispatch flow plan and the stateless
       classifier, the four flow columns against the multi-dispatch plan
       after each pass; then the p50 per admission of both (and of the
       stateless classifier) in turns, each pass from a cold table;
    2. the flow ladder's shape: per rung the same gate chunk by chunk, then
       packets/s of the resident, the multi-dispatch and the stateless pass
       in turns (launch counts zeroed before the resident pass and read
       after it); K7's and K8's resident entries against their plain
       versions chunk by chunk over the 90% trace (the step run eagerly,
       outputs, epochs and columns); per admission from the profiler: the
       kernels, memsets and copies of each plan; the entries' times beside
       their bounds and plain versions, and one graph replay's against the
       eager step;
    3. the superbatch (K = 4): every row and the columns against four
       single resident dispatches, then packets/s of both in turns;
    4. 1000 dispatches after mark_resident_warm: no capture, no
       allocation;
    5. serving while rules change (resident_edit_passes); the daemon with
       --resident over the flow phase's 1M-frame file read twice: its
       verdict files against the stateless daemon's, resident_* and
       flow_* on /metrics against the classifier's counters; then that
       daemon and a multi-dispatch flow daemon each read it without and
       with edit files landing (daemon_edit_pass)."""
    import shutil

    import torch

    from infw_torch import daemon, testing
    from infw_torch.backend.cuda import TorchClassifier
    from infw_torch.flow import FlowConfig, ResidentOps
    from infw_torch.kernels import all_kernels, flow as kflow
    from infw_torch.kernels.resident import resident_out_words, resident_step, stateless_res16

    # the profile child builds its host inputs while this phase runs
    profile = start_child("resident_profile_child")
    kernels = all_kernels()
    t0 = time.perf_counter()
    tables = testing.random_tables_fast(np.random.default_rng(8800), RESIDENT_ENTRIES, width=8,
                                        v6_fraction=0.5, ifindexes=(2, 3))
    cfg = FlowConfig.make(entries=FLOW_SLAB)
    res = TorchClassifier(device=DEV, force_path="trie", flow_table=cfg, resident=True)
    multi = TorchClassifier(device=DEV, force_path="trie", flow_table=cfg)
    base = TorchClassifier(device=DEV, force_path="trie")
    for c in (res, multi, base):
        c.load_tables(tables)
    log(f"resident: {tables.num_entries} entries x {tables.rule_width} rule slots (trie path), "
        f"flow table {cfg.capacity} x {cfg.ways}; set up in {time.perf_counter() - t0:.2f} s")

    def same(a, b) -> bool:
        return (np.array_equal(a.results, b.results) and np.array_equal(a.xdp, b.xdp)
                and np.array_equal(a.stats_delta, b.stats_delta))

    def same_columns(a, b, label: str) -> None:
        ca, cb = a.flow.flow_columns(), b.flow.flow_columns()
        if not all(np.array_equal(ca[k], cb[k]) for k in kflow.COLUMNS):
            raise SystemExit(f"resident {label}: the flow columns differ from the multi-dispatch "
                             f"plan's")

    def admit(c, chunk):
        w, v4, f = chunk
        return c.classify_prepared(c.prepare_packed(w, v4, tcp_flags=f), apply_stats=False).result()

    # 1. bench_resident's shape
    bench = {}
    steady_chunks = []
    bench_chunks = {}
    for bs in RESIDENT_BATCHES:
        batch, _meta = testing.flow_trace_batch(np.random.default_rng(8800 + bs), tables,
                                                bs * RESIDENT_CHUNKS, 0.9, chunk_packets=bs)
        tflags = np.asarray(batch.tcp_flags, np.int32)
        chunks = []
        for lo in range(0, len(batch), bs):
            sub = np.arange(lo, lo + bs, dtype=np.int64)
            w, v4 = batch.pack_wire_subset(sub)
            chunks.append((w, v4, np.ascontiguousarray(tflags[sub])))
        steady_chunks += chunks
        bench_chunks[bs] = chunks

        def lat_pass(c):
            if c.flow is not None:
                c.flow.reset()
            torch.cuda.synchronize()
            times = []
            for chunk in chunks:
                t = time.perf_counter()
                admit(c, chunk)
                times.append(time.perf_counter() - t)
            return float(np.median(times))

        res.flow.reset()
        multi.flow.reset()
        for k, chunk in enumerate(chunks):
            o = admit(res, chunk)
            if not (same(o, admit(multi, chunk)) and same(o, admit(base, chunk[:2] + (None,)))):
                raise SystemExit(f"resident B={bs}: admission {k} differs from the multi-dispatch "
                                 f"plan or the stateless classifier")
        same_columns(res, multi, f"B={bs} gate")
        r_p50 = m_p50 = s_p50 = float("inf")
        for _rep in range(RESIDENT_REPS):  # in turns, min of the p50s
            r_p50 = min(r_p50, lat_pass(res))
            m_p50 = min(m_p50, lat_pass(multi))
            same_columns(res, multi, f"B={bs} timed pass")
            s_p50 = min(s_p50, lat_pass(base))
        bench[bs] = {"resident_p50_us": r_p50 * 1e6, "multi_p50_us": m_p50 * 1e6,
                     "stateless_p50_us": s_p50 * 1e6}
        log(f"{tag} resident admission p50 at B={bs} ({RESIDENT_CHUNKS} admissions of a 90% "
            f"trace, each pass from a cold table, min of {RESIDENT_REPS} in turns): resident "
            f"{r_p50 * 1e6:.1f} us, multi-dispatch {m_p50 * 1e6:.1f} us ({m_p50 / r_p50:.3f}x), "
            f"stateless {s_p50 * 1e6:.1f} us; every admission equal to both, the columns "
            f"equal to the multi-dispatch plan's after every pass")

    # 2. the flow ladder's shape
    ltables, traces = FLOW_STASH["tables"], FLOW_STASH["traces"]
    lres = TorchClassifier(device=DEV, flow_table=cfg, resident=True)
    lmulti = TorchClassifier(device=DEV, flow_table=cfg)
    lbase = TorchClassifier(device=DEV)
    for c in (lres, lmulti, lbase):
        c.load_tables(ltables)

    def run_pass(c, batch):
        return [c.classify(batch.slice(lo, lo + FLOW_CHUNK), apply_stats=False)
                for lo in range(0, len(batch), FLOW_CHUNK)]

    def timed_pass(c, batch):
        if c.flow is not None:
            c.flow.reset()
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        t = time.perf_counter()
        run_pass(c, batch)
        return time.perf_counter() - t, {k.name: k.launches for k in kernels if k.launches}

    ladder = {}
    for pct, (batch, meta) in traces.items():
        lres.flow.reset()
        lmulti.flow.reset()
        outs = run_pass(lres, batch)
        for k, (o, m, b) in enumerate(zip(outs, run_pass(lmulti, batch), run_pass(lbase, batch))):
            if not (same(o, m) and same(o, b)):
                raise SystemExit(f"resident ladder {pct}%: chunk {k} differs from the "
                                 f"multi-dispatch plan or the stateless path")
        same_columns(lres, lmulti, f"ladder {pct}% gate")
        for c in (lres, lmulti, lbase):
            timed_pass(c, batch)  # warm, off the clock
        best = {"resident": (float("inf"), {}), "multi": (float("inf"), {}),
                "stateless": (float("inf"), {})}
        for _rep in range(FLOW_REPS):
            for name, c in (("resident", lres), ("multi", lmulti), ("stateless", lbase)):
                dt, ln = timed_pass(c, batch)
                if dt < best[name][0]:
                    best[name] = (dt, ln)
            same_columns(lres, lmulti, f"ladder {pct}% timed pass")
        ln = best["resident"][1]
        for name in ("flow_probe_resident", "flow_insert_resident", "trie_walk"):
            if ln.get(name, 0) <= 0:
                raise SystemExit(f"resident ladder {pct}%: {name} was not launched ({ln})")
        if ln.get("flow_probe", 0) or ln.get("flow_insert", 0):
            raise SystemExit(f"resident ladder {pct}%: the classic K7 or K8 ran ({ln})")
        pps = {k: FLOW_PACKETS / v[0] for k, v in best.items()}
        ladder[pct] = {f"{k}_pps": v for k, v in pps.items()}
        ladder[pct]["resident_launches"] = ln
        log(f"{tag} resident ladder {pct}% established: {pps['resident'] / 1e6:.3f} M packets/s "
            f"resident, {pps['multi'] / 1e6:.3f} multi-dispatch, {pps['stateless'] / 1e6:.3f} "
            f"stateless (resident / multi {pps['resident'] / pps['multi']:.3f}x, resident / "
            f"stateless {pps['resident'] / pps['stateless']:.3f}x; {meta['n_flows']} flows); "
            f"launches per resident pass {ln} ({FLOW_PACKETS // FLOW_CHUNK} chunks); every chunk "
            f"equal to both, the columns equal after every pass")

    # K7's and K8's resident entries against their plain versions over the
    # 90% trace, the step run eagerly on a card table and a clone of it
    batch, _meta = traces[90]
    dev = torch.device(DEV)
    ctx = lres.resident.context(lres)
    n_levels = ctx.tables.dev.n_levels
    step_tables = ctx.tables._replace(n_levels=n_levels)
    geo = {"slab_entries": cfg.entries, "ways": cfg.ways}
    got = kflow.empty_flow_table(cfg.capacity, dev)
    want = kflow.clone_flow_table(got)
    e_got = torch.zeros(1, dtype=torch.int32, device=dev)
    e_want = e_got.clone()
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    zt = torch.zeros(FLOW_CHUNK, dtype=torch.int32, device=dev)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)  # noqa: E731
    nw, nh = (FLOW_CHUNK + 1) // 2, -(-FLOW_CHUNK // 32)
    n_chunks = 0
    for k, lo in enumerate(range(0, len(batch), FLOW_CHUNK)):
        sub = batch.slice(lo, lo + FLOW_CHUNK)
        wire, fl = put(sub.pack_wire()), put(sub.tcp_flags.astype(np.int32))
        ops = ResidentOps(got, one, one, e_got, zt, fl, cfg.max_age, cfg.entries, cfg.ways)
        out = resident_step(ops, step_tables, wire)
        ref = torch.empty_like(out)
        kflow.flow_probe_resident_plain(want, one, one, wire, zt, fl, e_want, cfg.max_age,
                                        ref[: nw + nh + 2], **geo)
        kflow.flow_insert_resident_plain(want, one, one, wire, zt, fl,
                                         stateless_res16(step_tables, wire)[:nw],
                                         ref[nw: nw + nh], ref[:nw], ref[nw + nh + 2:], e_want,
                                         **geo)
        if not (torch.equal(out, ref) and torch.equal(e_got, e_want)
                and all(torch.equal(getattr(got, f), getattr(want, f)) for f in kflow.COLUMNS)):
            raise SystemExit(f"resident entries: chunk {k} of the 90% trace disagrees with the "
                             f"plain versions")
        n_chunks += 1
    torch.cuda.synchronize()
    log(f"K7 and K8 resident entries against their plain versions over the 90% trace: "
        f"{n_chunks} chunks, outputs, device epochs and the four columns equal after every chunk "
        f"({int((got.se[:, 0] > 0).sum())} live entries at the end)")

    # per admission from the profiler, and the entries' and the step's times
    sub = batch.slice(len(batch) // 2, len(batch) // 2 + FLOW_CHUNK)
    wire_np, flags_np = sub.pack_wire(), sub.tcp_flags
    per_admission = {}
    child = finish_child(profile, "resident profile child")
    for name, c in (("resident", lres), ("multi", lmulti), ("stateless", lbase)):
        per_admission[name] = (json.loads(child.strip().splitlines()[-1])
                               if name == "resident" else
                               admission_profile(lambda c=c: c.classify(sub, apply_stats=False)))
        t = time.perf_counter()
        for _ in range(50):
            c.classify(sub, apply_stats=False)
        per_admission[name]["host_us"] = (time.perf_counter() - t) / 50 * 1e6
        log(f"{tag} per admission at B={FLOW_CHUNK} ({name}): "
            + ", ".join(f"{k} {'not measured' if v is None else f'{v:.2f}'}"
                        for k, v in per_admission[name].items())
            + " (kernels, memsets and copies from the profiler, the resident admission's in a "
              "fresh process; device_us the kernels' sum; host_us the wall of a classify)")
    if (per_admission["resident"]["h2d"], per_admission["resident"]["d2h"]) != (1.0, 1.0):
        raise SystemExit(f"resident: {per_admission['resident']} copies per admission; expected "
                         f"one each way")
    wire, fl = put(wire_np), put(flags_np.astype(np.int32))
    ops = ResidentOps(kflow.clone_flow_table(got), one, one, e_got.clone(), zt, fl, cfg.max_age,
                      cfg.entries, cfg.ways)
    res16 = stateless_res16(step_tables, wire)
    hits = int(kflow.split_flow_probe_outputs(kflow.flow_probe_resident(
        kflow.clone_flow_table(got), one, one, wire, zt, fl, e_got.clone(), cfg.max_age,
        torch.empty(resident_out_words(FLOW_CHUNK), dtype=torch.int32, device=dev),
        **geo).cpu().numpy(), FLOW_CHUNK)[2])
    tbl = kflow.clone_flow_table(got)
    buf = torch.empty(resident_out_words(FLOW_CHUNK), dtype=torch.int32, device=dev)
    e_t = e_got.clone()

    def k7_call(t=tbl, b=buf, plain=False):
        fn = kflow.flow_probe_resident_plain if plain else kflow.flow_probe_resident
        return fn(t, one, one, wire, zt, fl, e_t, cfg.max_age, b, **geo)

    def k8_call(t=tbl, b=buf, plain=False):
        fn = kflow.flow_insert_resident_plain if plain else kflow.flow_insert_resident
        return fn(t, one, one, wire, zt, fl, res16[:nw], b[nw: nw + nh], b[:nw],
                  b[nw + nh + 2:], e_t, **geo)

    k7_call()
    inserts = int(k8_call()[0])
    timings = {}
    for key, call, bound in (
            ("k7", k7_call, flow_bytes("probe", 7, FLOW_CHUNK, cfg.ways, hits=hits) + 4),
            ("k8", k8_call, resident_insert_bytes(7, FLOW_CHUNK, cfg.ways, hits, inserts))):
        prof = admission_profile(call, 20)
        if prof["kernels"] is not None and (prof["kernels"] != 1 or prof["memsets"]):
            raise SystemExit(f"resident {key}: {prof} a call; expected one kernel, no memset")
        ptbl = kflow.clone_flow_table(got)
        pbuf = buf.clone()
        timings[key] = {
            "ms": cuda_ms(call, reps=50),
            "device_paced_ms": device_paced_ms(call),
            "device_ms": None if prof["device_us"] is None else prof["device_us"] / 1e3,
            "host_us": host_ms_per_call(call, 200) * 1e3,
            "bound_ms": bound / HBM_BYTES_PER_S * 1e3,
            "plain_ms": cuda_ms(lambda: call(ptbl, pbuf, True), reps=3, warmup=1),
        }
        r = timings[key]
        dv = "not measured" if r["device_ms"] is None else f"{r['device_ms'] * 1e3:.2f} us"
        log(f"{tag} {'K7' if key == 'k7' else 'K8'} resident entry at B={FLOW_CHUNK}, 7-word "
            f"wire: device {dv} a call (profiler, one kernel, no memset), "
            f"{r['device_paced_ms']:.5f} ms with the host ahead, {r['ms']:.5f} ms in a loop, host "
            f"{r['host_us']:.2f} us a call; bound {r['bound_ms']:.3e} ms by bytes ({hits} hits, "
            f"{inserts} inserts); plain version {r['plain_ms']:.4f} ms")
    # one graph replay against the eager step on the same operands
    g = next(iter(ctx.graphs.values()), None)
    eager_ops = ops._replace(flow=kflow.clone_flow_table(got))
    eager_out = torch.empty(resident_out_words(FLOW_CHUNK), dtype=torch.int32, device=dev)
    eager_ms = cuda_ms(lambda: resident_step(eager_ops, step_tables, wire, eager_out), reps=20)
    eager_paced = device_paced_ms(lambda: resident_step(eager_ops, step_tables, wire, eager_out))
    replay_ms = cuda_ms(g.graph.replay, reps=50) if g is not None else None
    replay_paced = device_paced_ms(g.graph.replay) if g is not None else None
    log(f"{tag} resident step at B={FLOW_CHUNK}: eager {eager_ms:.5f} ms in a loop, "
        f"{eager_paced:.5f} ms with the host ahead; one graph replay (bucket "
        f"{g.bucket if g else '-'}) {replay_ms:.5f} ms in a loop, {replay_paced:.5f} ms with the "
        f"host ahead")
    # the step's layers eager and as a graph: the stateless classify of
    # every lane (the path's fused wire entry and its torch ops) alone
    sgraph = torch.cuda.CUDAGraph()
    stateless_res16(step_tables, wire)
    with torch.cuda.graph(sgraph):
        stateless_res16(step_tables, wire)
    split = {}
    for name, fn in (("stateless_eager", lambda: stateless_res16(step_tables, wire)),
                     ("stateless_replay", sgraph.replay),
                     ("step_eager", lambda: resident_step(eager_ops, step_tables, wire,
                                                          eager_out)),
                     ("step_replay", g.graph.replay if g is not None else None)):
        if fn is not None:
            split[name] = {"ms": cuda_ms(fn, reps=20), "paced_ms": device_paced_ms(fn),
                           "host_us": host_ms_per_call(fn, 100) * 1e3}
    log(f"{tag} eager against graph at B={FLOW_CHUNK} (ms in a loop, ms with the host ahead, "
        f"host us a call): " + "; ".join(
            f"{k} {v['ms']:.5f} / {v['paced_ms']:.5f} / {v['host_us']:.1f}"
            for k, v in split.items()))
    del sgraph
    del g, ctx
    for c in (lres, lmulti, lbase):
        c.close()

    # 3. the superbatch (K = 4) against single resident dispatches, at
    # bench_pipeline's two admission sizes
    scfg = FlowConfig.make(entries=SUPER_SLAB)
    sup = TorchClassifier(device=DEV, force_path="trie", flow_table=scfg, resident=True)
    one_c = TorchClassifier(device=DEV, force_path="trie", flow_table=scfg, resident=True)
    for c in (sup, one_c):
        c.load_tables(tables)
    superbatch = {}
    for bs in SUPER_BATCHES:
        sbatch, _meta = testing.flow_trace_batch(np.random.default_rng(8900 + bs), tables,
                                                 bs * RESIDENT_CHUNKS, 0.9, chunk_packets=bs)
        wires = sbatch.pack_wire().reshape(-1, SUPER_K, bs, 7)
        sflags = np.asarray(sbatch.tcp_flags, np.int32).reshape(-1, SUPER_K, bs)

        def sup_pass():
            sup.flow.reset()
            torch.cuda.synchronize()
            t = time.perf_counter()
            rows = []
            for w, f in zip(wires, sflags):
                rows += [r.result() for r in sup.classify_prepared_super(
                    sup.prepare_packed_super(w, False, f), apply_stats=False)]
            return time.perf_counter() - t, rows

        def one_pass():
            one_c.flow.reset()
            torch.cuda.synchronize()
            t = time.perf_counter()
            rows = [one_c.classify_prepared(one_c.prepare_packed(w[j], False, tcp_flags=f[j]),
                                            apply_stats=False).result()
                    for w, f in zip(wires, sflags) for j in range(SUPER_K)]
            return time.perf_counter() - t, rows

        _dt, rows_s = sup_pass()
        _dt, rows_1 = one_pass()
        for k, (a, b) in enumerate(zip(rows_s, rows_1)):
            if not same(a, b):
                raise SystemExit(f"superbatch B={bs}: admission {k} differs from the single "
                                 f"dispatch")
        same_columns(sup, one_c, f"superbatch B={bs}")
        s_best = o_best = float("inf")
        for _rep in range(RESIDENT_REPS):
            s_best = min(s_best, sup_pass()[0])
            o_best = min(o_best, one_pass()[0])
        n_super = wires.shape[0] * SUPER_K * bs
        superbatch[bs] = {"superbatch_pps": n_super / s_best, "single_pps": n_super / o_best}
        log(f"{tag} resident superbatch K={SUPER_K} at B={bs} ({scfg.capacity}-entry flow "
            f"table, {wires.shape[0]} superbatches): {n_super / s_best / 1e6:.3f} M packets/s "
            f"against {n_super / o_best / 1e6:.3f} M single dispatches ({o_best / s_best:.3f}x, "
            f"min of {RESIDENT_REPS} in turns, each pass from a cold table); every admission and "
            f"the columns equal to the single dispatches'")
    sup.close()
    one_c.close()

    # 4. the warmed steady state: every shape on both slots, then 1000
    # dispatches
    shapes = {}
    for chunk in steady_chunks:
        shapes.setdefault((chunk[0].shape, chunk[1]), chunk)
    for chunk in shapes.values():
        for _ in range(2):
            admit(res, chunk)
    res.flow.warm(RESIDENT_BATCHES)
    res.mark_resident_warm()
    graphs = res.resident.graphs()
    t = time.perf_counter()
    for i in range(STEADY_DISPATCHES):
        admit(res, steady_chunks[i % len(steady_chunks)])
    steady_s = time.perf_counter() - t
    if res.resident.steady_allocs() != 0 or res.resident.graphs() != graphs:
        raise SystemExit(f"resident steady state: {res.resident.steady_allocs()} allocations, "
                         f"{res.resident.graphs() - graphs} new graphs in {STEADY_DISPATCHES} "
                         f"dispatches")
    log(f"resident steady state: {STEADY_DISPATCHES} dispatches after mark_resident_warm in "
        f"{steady_s:.3f} s, 0 allocations, no capture ({graphs} graphs); counters "
        f"{res.resident_counters()}")

    # 5. serving while rules change
    edits = resident_edit_passes(tag, tables, bench_chunks[128], res, multi, base, admit, same)
    for c in (res, multi, base):
        c.close()

    # the daemon with --resident over the flow phase's 1M-frame file, twice
    st = FLOW_STASH
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "resident-smoke")
    shutil.rmtree(root, ignore_errors=True)
    d = daemon.Daemon(state_dir=os.path.join(root, "resident"), node_name=DAEMON_NODE,
                      registry=st["daemon_registry"], metrics_port=0, health_port=0,
                      poll_period_s=0.1, file_poll_interval_s=0.02,
                      flow_table=FlowConfig.make(entries=FLOW_SLAB), resident=True,
                      backend="cuda" if DEV == "cuda" else "cpu")
    daemon_launches = {}
    try:
        d.start()
        p = os.path.join(d.nodestates_dir, f"{DAEMON_NODE}.json")
        with open(p + ".tmp", "w") as f:
            json.dump(st["daemon_doc"], f)
        os.replace(p + ".tmp", p)
        _wait(lambda: d.syncer.classifier is not None and d.syncer.classifier.tables is not None
              and bool(d.syncer.attached_interfaces()), "the resident daemon's NodeState", 300)
        c = d.syncer.classifier
        fb = st["daemon_fb"]
        for rnd in range(2):
            fn = f"{rnd}.frames"
            stage = os.path.join(d.state_dir, "staging")
            os.makedirs(stage, exist_ok=True)
            daemon.write_frames_file_v2(os.path.join(stage, fn), fb)
            torch.cuda.synchronize()
            for k in kernels:
                k.launches = 0
            t = time.perf_counter()
            os.replace(os.path.join(stage, fn), os.path.join(d.ingest_dir, fn))
            _wait(lambda: os.path.exists(os.path.join(d.out_dir, fn + ".verdicts.json")),
                  f"the resident daemon's pass {rnd}", 600, 0.002)
            dt = time.perf_counter() - t
            ln = {k.name: k.launches for k in kernels if k.launches}
            daemon_launches[f"resident {rnd}"] = ln
            got_bytes = open(os.path.join(d.out_dir, fn + ".verdicts.bin"), "rb").read()
            if got_bytes != st["daemon_stateless"]:
                raise SystemExit(f"resident daemon: pass {rnd}'s verdict file differs from the "
                                 f"stateless daemon's")
            log(f"{tag} resident daemon (pass {rnd}): {len(fb)} frames in {dt:.3f} s = "
                f"{len(fb) / dt / 1e6:.3f} M packets/s, launches {ln}; verdict file equal to the "
                f"stateless daemon's")
        if daemon_launches["resident 1"].get("flow_probe_resident", 0) <= 0:
            raise SystemExit(f"resident daemon: launches {daemon_launches}")
        counters = {**c.flow_counters(), **c.resident_counters()}
        for key in ("flow_hits_total", "flow_misses_total", "flow_inserts_total",
                    "flow_evictions_total", "flow_occupancy", "resident_dispatches_total",
                    "resident_fallbacks_total", "resident_allocs_total",
                    "resident_slot0_dispatches_total", "resident_slot1_dispatches_total"):
            if _metric(d, key) != counters[key]:
                raise SystemExit(f"resident daemon: /metrics {key} {_metric(d, key)} is not the "
                                 f"classifier's {counters[key]}")
        log(f"resident daemon: resident_* and flow_* on /metrics equal the classifier's "
            f"counters {counters}")
        edits["daemon"] = {"resident": daemon_edit_pass(tag, d, fb, "resident")}
    finally:
        d.stop()
    # the multi-dispatch flow daemon under the same edit files
    d = daemon.Daemon(state_dir=os.path.join(root, "multi"), node_name=DAEMON_NODE,
                      registry=st["daemon_registry"], metrics_port=0, health_port=0,
                      poll_period_s=0.1, file_poll_interval_s=0.02,
                      flow_table=FlowConfig.make(entries=FLOW_SLAB),
                      backend="cuda" if DEV == "cuda" else "cpu")
    try:
        d.start()
        p = os.path.join(d.nodestates_dir, f"{DAEMON_NODE}.json")
        with open(p + ".tmp", "w") as f:
            json.dump(st["daemon_doc"], f)
        os.replace(p + ".tmp", p)
        _wait(lambda: d.syncer.classifier is not None and d.syncer.classifier.tables is not None
              and bool(d.syncer.attached_interfaces()), "the flow daemon's NodeState", 300)
        edits["daemon"]["multi"] = daemon_edit_pass(tag, d, st["daemon_fb"], "multi-dispatch")
    finally:
        d.stop()
    shutil.rmtree(root, ignore_errors=True)

    for entry, key, name in ((k7, "k7", "flow_probe_resident"), (k8, "k8", "flow_insert_resident")):
        lad = ladder[90]["resident_launches"]
        entry["resident"] = {
            "name": name, "launches": lad.get(name, 0),
            "admissions": FLOW_PACKETS // FLOW_CHUNK,
            "launches_per_admission": lad.get(name, 0) / (FLOW_PACKETS // FLOW_CHUNK),
            **timings[key], "bound_by": "bytes",
            "daemon_launches": {p: cnt.get(name, 0) for p, cnt in daemon_launches.items()},
        }
    k7["resident"].update(ladder=ladder, bench_resident=bench, superbatch=superbatch,
                          per_admission=per_admission, edits=edits,
                          step_ms={"eager": eager_ms, "eager_paced": eager_paced,
                                   "replay": replay_ms, "replay_paced": replay_paced},
                          eager_graph_split=split)


# --- the telemetry plane (K9) -----------------------------------------------------
#
# bench_telemetry's shape (bench.py:3613-3920): random_tables_fast(100,000
# entries, width 8, 40% IPv6, ifindexes 2, 3) on the trie path,
# SketchSpec.make(), a synflood attack trace of 80 chunks of 256 packets
# (testing.attack_trace_batch, seed 1300), a 2^14 flow table, resident.

TELEMETRY_ENTRIES, TELEMETRY_CHUNK, TELEMETRY_CHUNKS = 100_000, 256, 80
#: batch sizes K9 is held against its plain version at, and timed at
K9_SIZES, K9_TIMED = (1, 31, 256, 4096, 65536), (256, 4096, 1 << 18)
#: the sizes both K9 plans are timed at (infw_torch.tools.sketch_plans; either
#: side of its 2048-lane crossover; two sizes for the script's time)
K9_LADDER = (2048, 2560)


def telemetry_tables():
    from infw_torch.tools.sketch_plans import telemetry_tables

    return telemetry_tables()


def k9_traces(tables, b: int) -> dict:
    """{"synflood": ..., "uniform": ...} K9 inputs of ``b`` lanes on the CPU
    (infw_torch.tools.sketch_plans.traces, which times both plans on them)."""
    from infw_torch.tools.sketch_plans import traces

    return traces(tables, b)


def k9_bytes(spec, b: int, width: int) -> int:
    """What the update must move: a lane's wire row, tenant, flags and
    verdict read once; the state (count-min rows, heavy-hitter keys and
    counts, tenant counters) read and written once each (it stays in L2,
    so this over-counts DRAM traffic: the bound is a floor of a floor)."""
    state = spec.depth * spec.width + spec.topk * 7 + spec.max_tenants * 4
    return b * (width + 3) * 4 + 2 * state * 4


def k9_check(ksk, spec, batches, grid: int = 0, resident: bool = False, plan=None,
             start=None) -> int:
    """K9 on the card against its plain version (plain PyTorch on the same
    card tensors) over ``batches`` from one state (``start``'s count-min
    rows, else zeros); ``plan`` forces K9's plan; the winner scratch back
    at -1 after every call and one launch a call.  Raises on a mismatch;
    returns the largest absolute difference (0)."""
    import torch

    from infw_torch.kernels.torchpath import _pack_res16

    dev = torch.device(DEV)
    got, want = ksk.zero_state(spec, dev), ksk.zero_state(spec, dev)
    if start is not None:
        got.cms.copy_(start)
        want.cms.copy_(start)
    winner = ksk.empty_winner(spec, dev)
    kern = ksk.RESIDENT_KERNEL if resident else ksk.KERNEL
    for wire, tenant, flags, res in batches:
        wire, tenant, flags, res = (x.to(dev) for x in (wire, tenant, flags, res))
        before = kern.launches
        if resident:
            res = res & 0xFFFF
            ksk.sketch_update_resident(got, wire, tenant, flags, _pack_res16(res.long()), spec,
                                       winner=winner, _grid=grid, _plan=plan)
        else:
            ksk.sketch_update(got, wire, tenant, flags, res, spec, winner=winner, _grid=grid,
                              _plan=plan)
        ksk.sketch_update_plain(want, wire, tenant, flags, res, spec)
        torch.cuda.synchronize()
        if kern.launches != before + 1:
            raise SystemExit(f"K9: {kern.launches - before} launches in one call")
        for f in ksk.SketchState._fields:
            if not torch.equal(getattr(got, f), getattr(want, f)):
                diff = (getattr(got, f).long() - getattr(want, f).long()).abs().max()
                raise SystemExit(f"K9 {'resident' if resident else 'classic'} entry disagrees "
                                 f"with its plain version on {f} (max |diff| {int(diff)}), "
                                 f"spec {spec}, B={wire.shape[0]}, grid {grid}, plan {plan}")
        if not bool((winner == -1).all()):
            raise SystemExit("K9 left its winner scratch dirty")
    return 0


def k9_parent_turns(tag: str, ksk, spec, args, label: str) -> dict:
    """--parent's K9 against this tree's on one timed input: both entries
    from one state leave equal tensors (the parent's classic entry, and its
    resident entry on the same verdicts packed), then the classic entries
    with the host ahead in turns (parent, this, this, parent).  Returns
    {"paced_ms": this tree's mean, "parent_paced_ms": the parent's}."""
    import torch

    from infw_torch.kernels.torchpath import _pack_res16

    wire, tenant, flags, res = args
    B = wire.shape[0]
    winner = ksk.empty_winner(spec, DEV)
    lanes = torch.empty(4 * B, dtype=torch.int32, device=DEV)
    res16 = _pack_res16(res.long() & 0xFFFF)

    def parent(st, resident=False):
        name = "sketch_update_resident" if resident else "sketch_update"
        a = ksk.kernel_args(st, winner, spec, wire, tenant, flags, res16 if resident else res,
                            lanes, 0, "L")
        PARENT_KERNELS[name].launch(*a, torch.cuda.current_stream().cuda_stream)

    for resident in (False, True):
        mine, theirs = ksk.zero_state(spec, DEV), ksk.zero_state(spec, DEV)
        for _ in range(2):
            if resident:
                ksk.sketch_update_resident(mine, wire, tenant, flags, res16, spec, winner=winner)
            else:
                ksk.sketch_update(mine, wire, tenant, flags, res, spec, winner=winner)
            parent(theirs, resident)
        torch.cuda.synchronize()
        if not all(torch.equal(getattr(mine, f), getattr(theirs, f))
                   for f in ksk.SketchState._fields) or not bool((winner == -1).all()):
            raise SystemExit(f"--parent's K9 disagrees with this tree's [{label}, "
                             f"{'resident' if resident else 'classic'} entry]")
    st_p, st_t = ksk.zero_state(spec, DEV), ksk.zero_state(spec, DEV)
    this_fn = lambda: ksk.sketch_update(st_t, wire, tenant, flags, res, spec, winner=winner)  # noqa: E731
    parent_fn = lambda: parent(st_p)  # noqa: E731
    p1, t1, t2, p2 = (device_paced_ms(fn, reps=20)
                      for fn in (parent_fn, this_fn, this_fn, parent_fn))
    log(f"{tag} parent vs this tree [K9 {label}], with the host ahead, in turns: parent "
        f"{p1:.5f}, {p2:.5f} ms; this {t1:.5f}, {t2:.5f} ms; this / parent "
        f"{(t1 + t2) / (p1 + p2):.3f}")
    return {"paced_ms": (t1 + t2) / 2, "parent_paced_ms": (p1 + p2) / 2}


def k9_profile_child() -> None:
    """Run in a fresh process by the telemetry phase (a trace in a process
    whose earlier profiler traces covered other work loses events): K9's
    kernels and device microseconds per call at each timed size on both
    traces, and one resident admission of the e2e cell (B = 4096) with the
    sketch on and off, printed as one JSON line."""
    from infw_torch import layout, testing
    from infw_torch.backend.cuda import TorchClassifier
    from infw_torch.flow import FlowConfig
    from infw_torch.kernels import sketch as ksk

    import torch

    tables = telemetry_tables()
    spec = ksk.SketchSpec.make()
    traces = {b: k9_traces(tables, b) for b in K9_TIMED}
    batch, _meta = testing.attack_trace_batch(np.random.default_rng(1300), tables, 4096 * 4,
                                              "synflood", chunk_packets=4096)
    layout.build_poptrie(tables)  # the trie path's host layout, memoized for the loads
    wait_for_go()
    out = {"k9": {}, "admission": {}}
    for b in K9_TIMED:
        for name, (wire, tenant, flags, res) in traces[b].items():
            st = ksk.zero_state(spec, DEV)
            winner = ksk.empty_winner(spec, DEV)
            args = [x.to(DEV) for x in (wire, tenant, flags, res)]
            counts = {}
            dev_us = profiled_kernels(lambda: ksk.sketch_update(st, *args, spec, winner=winner),
                                      10, counts)
            out["k9"][f"{name} {b}"] = {"device_us": sum(dev_us.values()) if dev_us else None,
                                        "kernels": counts}
    for label, tel in (("on", spec), ("off", None)):
        clf = TorchClassifier(device=DEV, force_path="trie", resident=True,
                              flow_table=FlowConfig.make(entries=1 << 14), telemetry=tel)
        clf.load_tables(tables)
        for lo in range(0, 3 * 4096, 4096):
            clf.classify(batch.slice(lo, lo + 4096), apply_stats=False)
        sub = batch.slice(3 * 4096, 4 * 4096)
        out["admission"][label] = admission_profile(lambda: clf.classify(sub, apply_stats=False))
    torch.cuda.synchronize()
    print(json.dumps(out), flush=True)


def telemetry_phase(tag: str) -> dict:
    """The telemetry plane (ROADMAP item 12) on the card; returns K9's
    kernels-line entry.

    1. K9 against its plain version: both entries at B = 1, 31, 256, 4096
       and 65536 on the 4- and 7-word wires (several batches from one
       state, tenants in and out of range), every way count 1-8 and depth
       1-8 at 4096, a saturating ``sat`` of 3, the synflood trace's hot
       keys, a forced grid of 1 and 3 blocks and the co-resident grid; each
       plan forced on both entries, the crossover and a lane either side,
       depth 8 x width 65536 (plan L unstaged), a start state above sat;
    2. bench_telemetry's cell through the entry points a user calls: the
       synflood trace's 80 chunks through a resident classifier with the
       telemetry plane, launch counts zeroed before and read after; the gate
       before any timing line: verdicts with telemetry on equal those with
       it off and the oracle's, and the sketch tensors of tracked twins
       (resident: K9's resident entry; multi-dispatch: its classic entry)
       equal their HostSketchModels; then packets/s with the plane on and
       off in turns (resident and multi-dispatch), and the chunks until a
       drained summary names the planted attacker (synflood, denystorm);
    3. K9's times at B = 256, 4096 and 2^18 on the synflood and a uniform
       trace (the plan plan_for takes at each): CUDA events back to back,
       with the host ahead, the device time from the profiler (a fresh
       process), the plain version, the bound; --parent's K9 held equal and
       timed in turns; both plans over a ladder of sizes (the crossover,
       ``infw_torch.tools.sketch_plans`` in a fresh process);
       the resident admission's device time with the sketch on and off
       (the same child); the step graph against the eager step with the
       sketch (outputs, columns and state equal; times with the host
       ahead);
    4. the daemon with --resident --telemetry --trace over the flow phase's
       1M-frame file: its verdict file against the stateless daemon's, the
       span histograms and telemetry_* counters on /metrics (the latter
       equal to the classifier's), the summaries in events.log."""
    import shutil

    import torch

    from infw_torch import daemon, oracle, testing
    from infw_torch.backend.cuda import TorchClassifier
    from infw_torch.flow import FlowConfig, ResidentOps
    from infw_torch.kernels import all_kernels, sketch as ksk
    from infw_torch.kernels import flow as kflow
    from infw_torch.kernels.resident import resident_fused_host, resident_step
    from infw_torch.obs.telemetry import SketchOps

    # the profile child builds its host inputs while this phase runs
    profile = start_child("k9_profile_child")
    kernels = all_kernels()
    t0 = time.perf_counter()
    tables = telemetry_tables()
    spec = ksk.SketchSpec.make()
    log(f"telemetry: {tables.num_entries} entries x {tables.rule_width} rule slots, spec {spec}; "
        f"made in {time.perf_counter() - t0:.2f} s")

    # 1. K9 against its plain version
    t0 = time.perf_counter()
    checked = 0
    pool = k9_traces(tables, 65536)
    rng = np.random.default_rng(1310)

    def draws(b, width, n=3, name="uniform", tenants=2):
        wire, _t, flags, res = pool[name]
        out = []
        for _ in range(n):
            idx = torch.from_numpy(rng.integers(0, wire.shape[0], b))
            w = wire[idx]
            if width == 4:
                w4 = np.ascontiguousarray(w.numpy().view(np.uint32)[:, [0, 1, 2, 3]])
                w4[:, 0] = (w4[:, 0] & ~np.uint32(3)) | np.uint32(1)
                w = torch.from_numpy(w4.view(np.int32))
            ten = torch.from_numpy(rng.integers(-1, tenants + 1, b).astype(np.int32))
            out.append((w, ten, flags[idx], res[idx]))
        return out

    two = ksk.SketchSpec.make(max_tenants=2)
    for b in K9_SIZES:
        for width in (4, 7):
            for resident in (False, True):
                checked += 1 + k9_check(ksk, two, draws(b, width), resident=resident)
    for k in range(1, 9):
        checked += 1 + k9_check(ksk, ksk.SketchSpec.make(ways=k, topk=64, max_tenants=2),
                                draws(4096, 7))
        checked += 1 + k9_check(ksk, ksk.SketchSpec.make(depth=k, width=256, max_tenants=2),
                                draws(4096, 7))
    checked += 1 + k9_check(ksk, ksk.SketchSpec.make(sat=3, width=64, topk=16, max_tenants=2),
                            draws(4096, 7))
    for grid in (1, 3):
        checked += 1 + k9_check(ksk, two, draws(65536, 7, name="synflood"), grid=grid)
        checked += 1 + k9_check(ksk, two, draws(65536, 7, name="synflood"), grid=grid,
                                resident=True)
    checked += 1 + k9_check(ksk, spec, [pool["synflood"]] * 3)
    # the two plans: each forced on both entries, both sides of the
    # crossover as plan_for chooses, the oversized geometry (plan L on
    # global atomics, unstaged) at small and large B and under forced grids,
    # a start state whose untouched count-min cells sit above sat
    cross = ksk.BLOCK_PLAN_MAX_LANES
    limit = ksk.smem_limit(torch.device(DEV))
    chosen = {b: ksk.plan_for(b, two, limit) for b in (cross - 1, cross, cross + 1)}
    if list(chosen.values()) != ["S", "S", "L"]:
        raise SystemExit(f"K9: plan_for around the crossover {cross}: {chosen}")
    for b in chosen:
        for resident in (False, True):
            checked += 1 + k9_check(ksk, two, draws(b, 7, n=2), resident=resident)
    for plan in ("S", "L"):
        for resident in (False, True):
            for b in (1, 256, 4096, 9000):
                checked += 1 + k9_check(ksk, two, draws(b, 7, n=2), resident=resident,
                                        plan=plan)
    big = ksk.SketchSpec.make(depth=8, width=65536, max_tenants=2)
    for b, grids in ((256, (0,)), (65536, (0, 1, 3))):
        if ksk.plan_for(b, big, limit) != "L":
            raise SystemExit("K9: plan_for took plan S for the oversized geometry")
        for grid in grids:
            checked += 1 + k9_check(ksk, big, draws(b, 7, n=2), grid=grid)
    sat40 = ksk.SketchSpec.make(sat=40, max_tenants=2)
    above = torch.from_numpy(rng.integers(0, 200, (4, 2048)).astype(np.int32))
    for plan in ("S", "L"):
        for resident in (False, True):
            checked += 1 + k9_check(ksk, sat40, draws(300, 7, n=2), resident=resident,
                                    plan=plan, start=above)
    log(f"K9 vs plain: {checked} configurations (both entries at B = {list(K9_SIZES)} on the 4- "
        f"and 7-word wires, ways 1-8, depth 1-8, sat 3, the synflood trace's hot keys, grids of "
        f"1 and 3 blocks and the co-resident grid; each plan forced on both entries at B = 1, "
        f"256, 4096, 9000; the crossover {cross} and one lane either side as plan_for chooses "
        f"({chosen}); depth 8 x width 65536 at B = 256 and 65536, grids of 0, 1 and 3; a start "
        f"state above sat 40 on both plans), 2-3 batches each from one state: every tensor "
        f"equal, the winner scratch back at -1; {time.perf_counter() - t0:.1f} s")

    # 2. bench_telemetry's cell through the classifier
    bs = TELEMETRY_CHUNK
    trace, meta = testing.attack_trace_batch(np.random.default_rng(1300), tables,
                                             bs * TELEMETRY_CHUNKS, "synflood", chunk_packets=bs)
    tflags = np.asarray(trace.tcp_flags, np.int32)
    chunks = []
    for lo in range(0, len(trace), bs):
        sub = np.arange(lo, lo + bs, dtype=np.int64)
        w, v4 = trace.pack_wire_subset(sub)
        chunks.append((w, v4, np.ascontiguousarray(tflags[sub])))
    fcfg = lambda: FlowConfig.make(entries=1 << 14)  # noqa: E731
    on = TorchClassifier(device=DEV, force_path="trie", flow_table=fcfg(), resident=True,
                         telemetry=spec)
    off = TorchClassifier(device=DEV, force_path="trie", flow_table=fcfg(), resident=True)
    con = TorchClassifier(device=DEV, force_path="trie", telemetry=spec)
    coff = TorchClassifier(device=DEV, force_path="trie")
    twin = TorchClassifier(device=DEV, force_path="trie", flow_table=fcfg(), resident=True,
                           telemetry=spec, telemetry_track_model=True)
    ctwin = TorchClassifier(device=DEV, force_path="trie", telemetry=spec,
                            telemetry_track_model=True)
    for c in (on, off, con, coff, twin, ctwin):
        c.load_tables(tables)

    def admit(c, chunk):
        w, v4, f = chunk
        return c.classify_prepared(c.prepare_packed(w, v4, tcp_flags=f), apply_stats=False).result()

    ref = oracle.classify(tables, trace)
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    outs = [admit(on, ch) for ch in chunks]
    launches = {k.name: k.launches for k in kernels if k.launches}
    # one launch an admission, and one more for each graph captured (its
    # first run, eager on inert rows, before the capture)
    captures = on.resident.graphs()
    if (launches.get("sketch_update_resident", 0) != len(chunks) + captures
            or launches.get("sketch_update")):
        raise SystemExit(f"telemetry main path: launches {launches}; expected "
                         f"{len(chunks)} + {captures} of sketch_update_resident and no classic "
                         f"one")
    n_div = 0
    for j, (o, ch) in enumerate(zip(outs, chunks)):
        want = ref.results[j * bs: (j + 1) * bs]
        n_div += int((o.results != want).sum())
        n_div += int((o.results != admit(off, ch).results).sum())
        n_div += int((o.results != admit(con, ch).results).sum())
        admit(twin, ch)
        admit(ctwin, ch)
    if n_div:
        raise SystemExit(f"telemetry gate: {n_div} verdicts differ (on, off, multi-dispatch, "
                         f"oracle)")
    for c, label in ((twin, "resident"), (ctwin, "multi-dispatch")):
        tel = c.telemetry
        tel.resident_note_materialized(0)
        cols, model = tel.columns(), tel.model.columns()
        for f in cols:
            if not np.array_equal(cols[f], model[f]):
                raise SystemExit(f"telemetry gate: the {label} twin's {f} differs from its "
                                 f"HostSketchModel")
    onc = on.telemetry.columns()
    if not all(np.array_equal(onc[f], twin.telemetry.columns()[f]) for f in onc):
        raise SystemExit("telemetry gate: the resident classifier's sketch differs from its twin")
    log(f"telemetry main path: {len(chunks)} admissions of {bs} packets (synflood, "
        f"{meta['n_attack']} attack lanes), launches {launches} ({captures} graph captures, "
        f"each after one eager run); gate: verdicts with the plane "
        f"on equal those with it off, the multi-dispatch plan's and the oracle's; the sketch "
        f"tensors of both tracked twins equal their HostSketchModels; tcnt {onc['tcnt'].tolist()}")

    def run_pass(c):
        if c.flow is not None:
            c.flow.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for ch in chunks:
            admit(c, ch)
        return time.perf_counter() - t

    best = {n: float("inf") for n in ("on", "off", "con", "coff")}
    for _ in range(3):
        for n, c in (("off", off), ("on", on), ("coff", coff), ("con", con)):
            best[n] = min(best[n], run_pass(c))
    pps = {n: len(trace) / v for n, v in best.items()}
    log(f"{tag} telemetry throughput ({len(trace)} packets in {bs}-packet admissions, min of 3 "
        f"in turns): resident {pps['on'] / 1e6:.4f} M/s on, {pps['off'] / 1e6:.4f} off "
        f"({pps['on'] / pps['off']:.3f}x); multi-dispatch {pps['con'] / 1e6:.4f} on, "
        f"{pps['coff'] / 1e6:.4f} off ({pps['con'] / pps['coff']:.3f}x)")
    detect = {}
    for mode in ("synflood", "denystorm"):
        dtrace, dmeta = testing.attack_trace_batch(np.random.default_rng(1400), tables, bs * 40,
                                                   mode, chunk_packets=bs)
        dflags = np.asarray(dtrace.tcp_flags, np.int32)
        det = TorchClassifier(device=DEV, force_path="trie", telemetry=spec)
        det.load_tables(tables)
        tier = det.telemetry
        tier.min_packets, tier.syn_flood_frac, tier.deny_storm_frac = 32, 0.3, 0.3
        start = dmeta["start"] // bs
        srcs = {".".join(str(x) for x in int(s[0]).to_bytes(4, "big")) if k == 1 else "v6"
                for s, k in dmeta["attackers"]}
        for ci in range(len(dtrace) // bs):
            sub = np.arange(ci * bs, (ci + 1) * bs, dtype=np.int64)
            w, v4 = dtrace.pack_wire_subset(sub)
            admit(det, (w, v4, np.ascontiguousarray(dflags[sub])))
            if ci < start:
                continue
            rec = tier.drain(force=True)[0]
            hit = any(h["src"] in srcs for h in rec.top)
            hit = hit and any(t["syn_flood" if mode == "synflood" else "deny_storm"]
                              for t in rec.tenants)
            if hit:
                detect[mode] = ci - start + 1
                break
        else:
            raise SystemExit(f"telemetry: the {mode} attacker never surfaced in a summary")
        det.close()
    log(f"telemetry detection: the drained summary names the attacker after "
        f"{detect['synflood']} (synflood) and {detect['denystorm']} (denystorm) admissions of "
        f"{bs} packets from the attack's start")

    # 3. K9's times, the resident admission on and off, graph against eager
    timings = {}
    for b in K9_TIMED:
        for name, (wire, tenant, flags, res) in k9_traces(tables, b).items():
            st = ksk.zero_state(spec, DEV)
            winner = ksk.empty_winner(spec, DEV)
            args = [x.to(DEV) for x in (wire, tenant, flags, res)]
            fn = lambda: ksk.sketch_update(st, *args, spec, winner=winner)  # noqa: E731
            plain_st = ksk.zero_state(spec, DEV)
            timings[f"{name} {b}"] = {
                "plan": ksk.plan_for(b, spec, limit),
                "ms": cuda_ms(fn, reps=20), "paced_ms": device_paced_ms(fn, reps=20),
                "plain_ms": cuda_ms(lambda: ksk.sketch_update_plain(plain_st, *args, spec),
                                    reps=3, warmup=1),
                "bound_ms": k9_bytes(spec, b, 7) / HBM_BYTES_PER_S * 1e3,
            }
            if "sketch_update" in PARENT_KERNELS:
                timings[f"{name} {b}"]["parent_in_turns"] = k9_parent_turns(
                    tag, ksk, spec, args, f"{name} {b}")
    child = finish_child(profile, "K9 profile child")
    prof = json.loads(child.strip().splitlines()[-1])
    for key, t in timings.items():
        t["device_us"] = prof["k9"][key]["device_us"]
        t["kernels"] = prof["k9"][key]["kernels"]
        dev_ms = t["device_us"] / 1e3 if t["device_us"] else None
        log(f"{tag} K9 sketch_update [{key}], plan {t['plan']}: events {t['ms']:.5f} ms, with "
            f"the host ahead {t['paced_ms']:.5f} ms, device "
            f"{t['device_us'] if t['device_us'] else 'lost'} us ({t['kernels']}); bound "
            f"{t['bound_ms']:.6f} ms by bytes"
            + (f" ({dev_ms / t['bound_ms']:.2f}x)" if dev_ms else "")
            + f"; plain {t['plain_ms']:.4f} ms")
    # the crossover: both plans over a ladder of sizes, in a fresh process
    child = run_child([sys.executable, "-m", "infw_torch.tools.sketch_plans", "--sizes",
                       ",".join(str(b) for b in K9_LADDER)], "K9 plan ladder")
    for line in child.stdout.strip().splitlines()[:-1]:
        log(f"{tag} {line}")
    ladder = json.loads(child.stdout.strip().splitlines()[-1])
    log(f"{tag} K9 crossover: plan S no slower than plan L on both traces up to B = "
        f"{ladder['crossover']} of the ladder; plan_for's crossover {ksk.BLOCK_PLAN_MAX_LANES}")
    adm = prof["admission"]
    log(f"{tag} resident admission (4096 packets, synflood trace) device time: sketch on "
        f"{adm['on']['device_us']} us in {adm['on']['kernels']} kernels, off "
        f"{adm['off']['device_us']} us in {adm['off']['kernels']} kernels; copies "
        f"{adm['on']['h2d']} / {adm['on']['d2h']} on, {adm['off']['h2d']} / {adm['off']['d2h']} "
        f"off")
    # the graph against the eager step, with the sketch
    big, _m = testing.attack_trace_batch(np.random.default_rng(1305), tables, 4096 * 3,
                                         "synflood", chunk_packets=4096)
    for lo in range(0, 2 * 4096, 4096):
        on.classify(big.slice(lo, lo + 4096), apply_stats=False)
    sub = big.slice(2 * 4096, 3 * 4096)
    wire_np = sub.pack_wire()
    ctx = on.resident.context(on)
    step_tables = ctx.tables._replace(n_levels=ctx.tables.dev.n_levels)
    tier, tel = on.flow, on.telemetry
    eager_flow = kflow.clone_flow_table(tier._flow)
    eager_epoch = tier._epoch_dev.clone()
    eager_sk = ksk.SketchState(*(t.clone() for t in tel._state))
    gens_op, pages_op = tier._res_ops
    dev = torch.device(DEV)
    fl = torch.from_numpy(np.asarray(sub.tcp_flags, np.int32)).to(dev)
    ops = ResidentOps(eager_flow, gens_op.clone(), pages_op.clone(), eager_epoch,
                      torch.zeros(4096, dtype=torch.int32, device=dev), fl, tier.config.max_age,
                      tier.config.entries, tier.config.ways,
                      SketchOps(eager_sk, ksk.empty_winner(spec, dev), spec))
    wire_dev = torch.from_numpy(wire_np.view(np.int32)).to(dev)
    eager = resident_step(ops, step_tables, wire_dev)
    plan = on.prepare_packed(wire_np, False, tcp_flags=sub.tcp_flags)
    if not np.array_equal(resident_fused_host(plan["fused"]), eager.cpu().numpy()):
        raise SystemExit("telemetry: the resident graph's output differs from the eager step's")
    for c in kflow.COLUMNS:
        if not torch.equal(getattr(tier._flow, c), getattr(eager_flow, c)):
            raise SystemExit(f"telemetry: the graph's flow column {c} differs from the eager step")
    for f in ksk.SketchState._fields:
        if not torch.equal(getattr(tel._state, f), getattr(eager_sk, f)):
            raise SystemExit(f"telemetry: the graph's sketch {f} differs from the eager step's")
    on.classify_prepared(plan, apply_stats=False).result()
    graph = next((g for key, g in ctx.graphs.items() if key[0] == 4096), None)
    if graph is None and DEV == "cuda":
        raise SystemExit("telemetry: the resident pool captured no 4096-lane graph")
    eager_ms = device_paced_ms(lambda: resident_step(ops, step_tables, wire_dev), reps=10)
    replay_ms = None if graph is None else device_paced_ms(graph.graph.replay, reps=10)
    log(f"{tag} resident step with the sketch, 4096 packets: the graph's output, flow columns and "
        f"sketch equal the eager step's; with the host ahead the eager step {eager_ms:.4f} ms, "
        f"the graph replay {replay_ms} ms")
    for c in (on, off, con, coff, twin, ctwin):
        c.close()

    # 4. the daemon with --resident --telemetry --trace
    st = FLOW_STASH
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "telemetry-smoke")
    shutil.rmtree(root, ignore_errors=True)
    d = daemon.Daemon(state_dir=os.path.join(root, "state"), node_name=DAEMON_NODE,
                      registry=st["daemon_registry"], metrics_port=0, health_port=0,
                      poll_period_s=0.1, file_poll_interval_s=0.02,
                      flow_table=FlowConfig.make(entries=FLOW_SLAB), resident=True,
                      telemetry=spec, telemetry_drain=4, trace=True,
                      backend="cuda" if DEV == "cuda" else "cpu")
    daemon_launches = {}
    try:
        d.start()
        p = os.path.join(d.nodestates_dir, f"{DAEMON_NODE}.json")
        with open(p + ".tmp", "w") as f:
            json.dump(st["daemon_doc"], f)
        os.replace(p + ".tmp", p)
        _wait(lambda: d.syncer.classifier is not None and d.syncer.classifier.tables is not None
              and bool(d.syncer.attached_interfaces()), "the telemetry daemon's NodeState", 300)
        c = d.syncer.classifier
        # the idle loop attaches the ring and the drain cadence after the
        # tick that synced: land the file once it has
        _wait(lambda: id(c.telemetry) in d._telemetry_attached,
              "the telemetry daemon's idle-loop attach", 60)
        fb = st["daemon_fb"]
        stage_dir = os.path.join(d.state_dir, "staging")
        os.makedirs(stage_dir, exist_ok=True)
        daemon.write_frames_file_v2(os.path.join(stage_dir, "0.frames"), fb)
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        t = time.perf_counter()
        os.replace(os.path.join(stage_dir, "0.frames"), os.path.join(d.ingest_dir, "0.frames"))
        _wait(lambda: os.path.exists(os.path.join(d.out_dir, "0.frames.verdicts.json")),
              "the telemetry daemon's pass", 600, 0.002)
        dt = time.perf_counter() - t
        daemon_launches["telemetry 0"] = {k.name: k.launches for k in kernels if k.launches}
        got = open(os.path.join(d.out_dir, "0.frames.verdicts.bin"), "rb").read()
        if got != st["daemon_stateless"]:
            raise SystemExit("telemetry daemon: its verdict file differs from the stateless "
                             "daemon's")
        if daemon_launches["telemetry 0"].get("sketch_update_resident", 0) <= 0:
            raise SystemExit(f"telemetry daemon: launches {daemon_launches}")
        # every admission lands in exactly one drained window: once the idle
        # loop's timer has closed the last window, the summaries' admissions
        # add up to the tier's and their seqs run 1..drain_seq without a gap
        # (the jobs in flight are dispatched before the first drain
        # materializes, so the cadence alone does not fix the drain count)
        _wait(lambda: c.telemetry_counters()["telemetry_window_admissions"] == 0,
              "the telemetry daemon's last window to drain", 60)
        tc = c.telemetry_counters()

        def summaries():
            return [tuple(int(x.split("=")[1]) for x in line.split()[1:3])
                    for line in open(d.events_path).read().splitlines()
                    if line.startswith("telemetry-summary ")]

        _wait(lambda: len(summaries()) >= tc["telemetry_drain_seq"],
              "the telemetry daemon's summaries in events.log", 60)
        got = summaries()
        if ([seq for seq, _a in got] != list(range(1, tc["telemetry_drain_seq"] + 1))
                or sum(a for _seq, a in got) != tc["telemetry_admissions_total"]
                or not got):
            raise SystemExit(f"telemetry daemon: summaries (seq, admissions) {got} against the "
                             f"tier's {tc}")
        import urllib.request

        body = urllib.request.urlopen(f"http://127.0.0.1:{d.actual_metrics_port}/metrics",
                                      timeout=10).read().decode()
        stages = [s for s in ("ingest", "pack", "h2d", "dispatch", "materialize", "drain")
                  if f'ingressnodefirewall_node_span_us_count{{stage="{s}"}}' in body]
        if len(stages) != 6:
            raise SystemExit(f"telemetry daemon: /metrics has span histograms for {stages}")
        for key in ("telemetry_updates_total", "telemetry_drains_total",
                    "telemetry_summaries_total", "telemetry_admissions_total"):
            if _metric(d, key) != tc[key]:
                raise SystemExit(f"telemetry daemon: /metrics {key} {_metric(d, key)} is not the "
                                 f"classifier's {tc[key]}")
        counts = {s: d.tracer.histograms.values()[s]["count"] for s in stages}
        log(f"{tag} telemetry daemon (--resident --telemetry --trace): {len(fb)} frames in "
            f"{dt:.3f} s = {len(fb) / dt / 1e6:.3f} M packets/s, launches "
            f"{daemon_launches['telemetry 0']}; verdict file equal to the stateless daemon's; "
            f"/metrics span histograms for {stages} (counts {counts}), telemetry_* equal to the "
            f"classifier's {tc}; telemetry-summary records (seq, admissions) {got} in events.log, "
            f"every admission in one")
    finally:
        d.stop()
    shutil.rmtree(root, ignore_errors=True)

    main = timings[f"synflood {TELEMETRY_CHUNK}"]
    return {
        "name": "sketch_update", "route": "cuda",
        "source": "infw_torch/kernels/csrc/sketch_update.cu",
        "replaces": "infw/kernels/sketch.py:281",
        "launches": launches.get("sketch_update_resident", 0),
        "mismatches": 0, "max_abs_err": 0,
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "entries": {"classic": "sketch_update", "resident": "sketch_update_resident"},
        "checked_configurations": checked, "timings": timings, "admission": adm,
        "plans": {key: t["plan"] for key, t in timings.items()},
        "plan_ladder": ladder["sizes"], "crossover_measured": ladder["crossover"],
        "step_ms": {"eager_paced": eager_ms, "replay_paced": replay_ms},
        "throughput_pps": pps, "detect_admissions": detect,
        "telemetry_daemon_launches": daemon_launches,
    }


MLSCORE_CHUNK, MLSCORE_CHUNKS = 256, 60
K10_SIZES, K10_TIMED = (1, 256, 4096, 1 << 18), (256, 4096, 1 << 18)
#: the sizes the scoring phase's plan ladder times both of K10's plans at (either
#: side of the 1024-lane crossover; two sizes for the script's time)
K10_LADDER = (1024, 1280)


def mlscore_tables():
    """bench_mlscore's tables (bench.py:4064-4067): 100,000 entries, width 8,
    40% IPv6, ifindexes 2, 3 (the trie path: K2 serves)."""
    from infw_torch import testing

    return testing.random_tables_fast(np.random.default_rng(2024), 100_000, width=8,
                                      v6_fraction=0.4, ifindexes=(2, 3))


def k10_bytes(spec, b: int, width: int) -> int:
    """What the score update must move: a lane's wire row, tenant, flags and
    verdict read once and its score, anomaly flag and verdict written once;
    the state (source keys and columns, count-min rows, tenant counters,
    epoch) read and written once each; the model's values and the policy
    rows read once."""
    T, D, L, H = spec.trees, spec.depth, spec.leaves, spec.hidden
    state = (spec.slots * 14 + spec.cms_depth * spec.cms_width + spec.max_tenants * 4 + 1) * 4
    model = 2 * T * D * 4 + T * L + 16 * H + 5 * H + 4 + 8 + spec.max_tenants * 8
    return b * (width + 3 + 3) * 4 + 2 * state + model


def k10_check(kms, spec, model, tparams, batches, resident: bool = False, start=None,
              seed: int = 0, plan=None) -> int:
    """K10 on the card against its plain version (plain PyTorch on the same
    card tensors) over chained admissions from one state (``start``, host
    arrays, else zeros): after each, equal state tensors, equal outputs
    (classic: [score, anom, res']; resident: the probe's and the stateless
    words and the anomaly and score words, from a random hit bitmap and
    served words), one launch a call, the per-slot scratch back at -1 / 0;
    ``plan`` forces K10's plan (None: plan_for's).  Raises on a mismatch;
    returns the largest absolute difference (0)."""
    import torch

    from infw_torch.kernels.flow import pack_bits32
    from infw_torch.kernels.torchpath import _pack_res16

    dev = torch.device(DEV)
    host = start or {k: np.asarray(v) for k, v in zip(kms.ScoreState._fields,
                                                      kms.zero_state_host(spec))}

    def ops():
        return kms.ScoreOps(kms.state_from_host(host, dev), kms.model_device(model, dev),
                            torch.from_numpy(tparams.copy()).to(dev),
                            kms.empty_scratch(spec, dev), spec)

    got, want = ops(), ops()
    idle = kms.empty_scratch(spec, dev)
    rng = np.random.default_rng(seed)
    kern = kms.RESIDENT_KERNEL if resident else kms.KERNEL
    where = f"spec {spec}, plan {plan or 'plan_for'}"
    for j, batch in enumerate(batches):
        wire, tenant, flags, res = (x.to(dev) for x in batch)
        B = wire.shape[0]
        before = kern.launches
        if resident:
            nw, nh = (B + 1) // 2, -(-B // 32)
            hit = torch.from_numpy(rng.random(B) < 0.5).to(dev)
            served = torch.from_numpy(rng.integers(0, 1 << 16, B)).to(dev)
            words = []
            for o, entry in ((got, lambda *x: kms.score_update_resident(*x, plan=plan)),
                             (want, kms.score_update_resident_plain)):
                bufs = (_pack_res16(served), pack_bits32(hit), _pack_res16(res.long() & 0xFFFF),
                        torch.full((nh + nw,), -7, dtype=torch.int32, device=dev))
                entry(o, wire, tenant, flags, *bufs)
                words.append(bufs)
            pairs = list(zip(("served", "hit", "res16", "out"), *words))
        else:
            pairs = [("out", kms.score_update(got, wire, tenant, flags, res, plan=plan),
                      kms.score_update_out_plain(want, wire, tenant, flags, res))]
        torch.cuda.synchronize()
        if kern.launches != before + 1:
            raise SystemExit(f"K10: {kern.launches - before} launches in one call")
        for name, a, b in pairs:
            if not torch.equal(a, b):
                raise SystemExit(f"K10 {'resident' if resident else 'classic'} entry disagrees "
                                 f"with its plain version on {name} (admission {j}), {where}, "
                                 f"B={B}")
        for f in kms.ScoreState._fields:
            a, b = getattr(got.state, f), getattr(want.state, f)
            if not torch.equal(a, b):
                diff = int((a.long() - b.long()).abs().max())
                raise SystemExit(f"K10 {'resident' if resident else 'classic'} entry disagrees "
                                 f"with its plain version on {f} (max |diff| {diff}, admission "
                                 f"{j}), {where}, B={B}")
        if not torch.equal(got.scratch, idle):
            raise SystemExit(f"K10 left its slot scratch dirty (admission {j}), {where}, B={B}")
    return 0


def k10_ops(kms, spec, model):
    """Zero score state, ``model`` and the default policy rows on the card,
    with a per-slot scratch of its own (no fill a call)."""
    import torch

    return kms.ScoreOps(kms.zero_state(spec, DEV), kms.model_device(model, DEV),
                        torch.from_numpy(kms.zero_tparams(spec)).to(DEV),
                        kms.empty_scratch(spec, DEV), spec)


def k10_parent_turns(tag: str, kms, spec, model, args, label: str) -> dict:
    """--parent's K10 against this tree's on one timed input: from one state,
    two admissions through each entry leave equal state tensors and outputs
    (the resident entry on the same verdicts packed, with a seeded hit
    bitmap and served words), then the classic entries with the host ahead
    in turns (parent, this, this, parent).  The parent's five-launch design
    takes a per-lane scratch and its own slot scratch (it leaves its bids
    there).  Returns {"paced_ms": this tree's mean, "parent_paced_ms": the
    parent's}."""
    import torch

    from infw_torch.kernels.flow import pack_bits32
    from infw_torch.kernels.torchpath import _pack_res16

    wire, tenant, flags, res = args
    B = wire.shape[0]
    nw, nh = (B + 1) // 2, -(-B // 32)
    old = k10_planless(PARENT_KERNELS["score_update"].csrc)
    lanes = torch.empty(4 * B, dtype=torch.int32, device=DEV)
    theirs_scratch = kms.empty_scratch(spec, DEV)
    rng = np.random.default_rng(B)
    hit = pack_bits32(torch.from_numpy(rng.random(B) < 0.5).to(DEV))
    served0 = _pack_res16(torch.from_numpy(rng.integers(0, 1 << 16, B)).to(DEV))

    def parent(ops, words=None):
        o = ops._replace(scratch=theirs_scratch)
        if words is None:
            out = torch.empty(3 * B, dtype=torch.int32, device=DEV)
            a = kms.kernel_args(o, wire, tenant, flags, res, None, None, theirs_scratch, lanes,
                                out, 0, "L")
        else:
            out = words[3]
            a = kms.kernel_args(o, wire, tenant, flags, words[2], words[0], words[1],
                                theirs_scratch, lanes, out, 0,
                                kms.plan_for(B, spec, kms.smem_limit(torch.device(DEV))))
        if old:
            a = a[:-2]
        elif words is None:
            a = a[:-1] + (kms.PLANS[kms.plan_for(B, spec, kms.smem_limit(torch.device(DEV)))],)
        name = "score_update" if words is None else "score_update_resident"
        PARENT_KERNELS[name].launch(*a, torch.cuda.current_stream().cuda_stream)
        return out

    for resident in (False, True):
        mine, theirs = k10_ops(kms, spec, model), k10_ops(kms, spec, model)
        outs = []
        for _ in range(2):
            if resident:
                wm = (served0.clone(), hit, _pack_res16(res.long() & 0xFFFF),
                      torch.zeros(nh + nw, dtype=torch.int32, device=DEV))
                wt = tuple(t.clone() for t in wm)
                kms.score_update_resident(mine, wire, tenant, flags, *wm)
                parent(theirs, wt)
                outs.append((wm, wt))
            else:
                outs.append(((kms.score_update(mine, wire, tenant, flags, res),),
                             (parent(theirs),)))
        torch.cuda.synchronize()
        same = all(torch.equal(getattr(mine.state, f), getattr(theirs.state, f))
                   for f in kms.ScoreState._fields)
        same = same and all(torch.equal(x, y) for m, t in outs for x, y in zip(m, t))
        if not same:
            raise SystemExit(f"--parent's K10 disagrees with this tree's [{label}, "
                             f"{'resident' if resident else 'classic'} entry]")
    st_p, st_t = k10_ops(kms, spec, model), k10_ops(kms, spec, model)
    this_fn = lambda: kms.score_update(st_t, wire, tenant, flags, res)  # noqa: E731
    parent_fn = lambda: parent(st_p)  # noqa: E731
    p1, t1, t2, p2 = (device_paced_ms(fn, reps=20)
                      for fn in (parent_fn, this_fn, this_fn, parent_fn))
    log(f"{tag} parent vs this tree [K10 {label}], with the host ahead, in turns: parent "
        f"{p1:.5f}, {p2:.5f} ms; this {t1:.5f}, {t2:.5f} ms; this / parent "
        f"{(t1 + t2) / (p1 + p2):.3f}")
    return {"paced_ms": (t1 + t2) / 2, "parent_paced_ms": (p1 + p2) / 2}


def k10_profile_child() -> None:
    """Run in a fresh process by the scoring phase: K10's kernels and device
    microseconds per call at each timed size on both traces, and one
    resident admission of bench_mlscore's tables at B = 4096 with scoring
    on and off, printed as one JSON line."""
    import torch

    from infw_torch import layout, testing
    from infw_torch.backend.cuda import TorchClassifier
    from infw_torch.flow import FlowConfig
    from infw_torch.kernels import mxu_score as kms

    tables = mlscore_tables()
    traces = {b: k9_traces(tables, b) for b in K10_TIMED}
    batch, _meta = testing.attack_trace_batch(np.random.default_rng(1400), tables, 4096 * 4,
                                              "synflood", chunk_packets=4096)
    layout.build_poptrie(tables)  # the trie path's host layout, memoized for the loads
    wait_for_go()
    spec = kms.ScoreSpec.make()
    model = kms.default_model(spec)
    out = {"k10": {}, "admission": {}}
    for b in K10_TIMED:
        for name, args in traces[b].items():
            ops = k10_ops(kms, spec, model)
            args = [x.to(DEV) for x in args]
            counts = {}
            dev_us = profiled_kernels(lambda: kms.score_update(ops, *args), 10, counts)
            out["k10"][f"{name} {b}"] = {"device_us": sum(dev_us.values()) if dev_us else None,
                                         "kernels": counts, "per_kernel_us": dev_us}
    for label, ml in (("on", spec), ("off", None)):
        clf = TorchClassifier(device=DEV, force_path="trie", resident=True,
                              flow_table=FlowConfig.make(entries=1 << 14), mlscore=ml)
        clf.load_tables(tables)
        for lo in range(0, 3 * 4096, 4096):
            clf.classify(batch.slice(lo, lo + 4096), apply_stats=False)
        sub = batch.slice(3 * 4096, 4 * 4096)
        out["admission"][label] = admission_profile(lambda: clf.classify(sub, apply_stats=False))
    torch.cuda.synchronize()
    print(json.dumps(out), flush=True)


def mlscore_phase(tag: str) -> dict:
    """The anomaly-scoring tier (ROADMAP item 13) on the card; returns K10's
    kernels-line entry.

    1. K10 against its plain version through both entries, three chained
       admissions each, at B = 1, 256, 4096 and 2^18 on the synflood and a
       uniform trace: the default spec (forest only), a head of 8 with the
       clamp-stress model, a head of 64 of random weights with qshift (2, 5),
       sat 2^31 - 1, four tenants with ids -1 and 4 in the trace, 100 tenants
       (past the block tally of the tenant counters), shadow and enforce with
       a threshold that fires; the 4-word wire; a start state above sat on
       both entries;
    2. bench_mlscore's cell (bench.py:4029-4083) through the entry points a
       user calls: 60 synflood admissions of 256 packets (seed 1400), a 2^14
       flow table, served resident and multi-dispatch on the card and resident
       on the CPU (the plain versions), in shadow and in enforce, launch
       counts zeroed before and read after each: verdicts, XDP, statistics,
       score tensors, recent masks and flow columns equal across the three,
       shadow verdicts equal to the oracle, every enforced rewrite a Deny
       with ruleId 0 off the failsafe cells, failsafe cells keep their rule
       verdicts with everything anomalous; a model swap and two mode flips
       bump the flow generation and capture no graph; the admissions from
       the attack's onset until a drained anomaly-verdict record names the
       attacker (synflood, portscan);
    3. K10's times at B = 256, 4096 and 2^18 (CUDA events back to back and
       with the host ahead, the profiler's device time in a fresh process,
       the plain version, the bound); the resident admission at 4096 with
       scoring on and off (the same child);
    4. the daemon with --resident --mlscore over the flow phase's 1M-frame
       file: verdict files equal to the stateless daemon's; a model artifact
       dropped into models/ between two passes swaps (mlscore_model_swaps_total
       1, the flow generation bumped, no graph captured by the second pass);
       mlscore_* on /metrics equal to the classifier's; anomaly-verdict lines
       in events.log."""
    import shutil

    import torch

    from infw_torch import daemon, mlscore as ml, oracle, testing
    from infw_torch.backend.cuda import TorchClassifier
    from infw_torch.flow import FlowConfig
    from infw_torch.kernels import all_kernels, mxu_score as kms

    # the profile child builds its host inputs while this phase runs
    profile = start_child("k10_profile_child")
    kernels = all_kernels()
    t0 = time.perf_counter()
    tables = mlscore_tables()
    spec = kms.ScoreSpec.make()
    model = kms.default_model(spec)
    log(f"mlscore: {tables.num_entries} entries x {tables.rule_width} rule slots, spec {spec}; "
        f"made in {time.perf_counter() - t0:.2f} s")

    # 1. K10 against its plain version
    t0 = time.perf_counter()
    pool = k9_traces(tables, 1 << 18)
    rng = np.random.default_rng(1410)

    def draws(b, name, n=3, tenants=None, width=7):
        wire, tenant, flags, res = pool[name]
        out = []
        for _ in range(n):
            idx = torch.from_numpy(rng.integers(0, wire.shape[0], b))
            w = wire[idx]
            if width == 4:
                w4 = np.ascontiguousarray(w.numpy().view(np.uint32)[:, [0, 1, 2, 3]])
                w4[:, 0] = (w4[:, 0] & ~np.uint32(3)) | np.uint32(1)
                w = torch.from_numpy(w4.view(np.int32))
            ten = (tenant[idx] if tenants is None else
                   torch.from_numpy(rng.choice(np.asarray(tenants, np.int32), b)))
            out.append((w, ten, flags[idx], res[idx]))
        return out

    h8, h64 = kms.ScoreSpec.make(hidden=8), kms.ScoreSpec.make(hidden=64)
    sat_max, t4 = kms.ScoreSpec.make(sat=2**31 - 1), kms.ScoreSpec.make(max_tenants=4, hidden=4)
    t100 = kms.ScoreSpec.make(max_tenants=100, hidden=4)
    configs = [
        ("default", spec, model, kms.zero_tparams(spec), None),
        ("head 8, clamp-stress, enforce", h8, kms.clamp_stress_model(h8),
         kms.zero_tparams(h8, enforce=True), None),
        ("head 64, random, qshift (2, 5), enforce", h64,
         testing.random_score_model(np.random.default_rng(64), h64),
         kms.zero_tparams(h64, threshold=0, enforce=True), None),
        ("sat 2^31 - 1", sat_max, kms.default_model(sat_max), kms.zero_tparams(sat_max), None),
        ("4 tenants, ids -1..4, enforce", t4, kms.clamp_stress_model(t4),
         kms.zero_tparams(t4, threshold=-1000, enforce=True), (-1, 0, 1, 2, 3, 4)),
        ("100 tenants (counters past the block tally), enforce", t100,
         kms.clamp_stress_model(t100), kms.zero_tparams(t100, threshold=-1000, enforce=True),
         tuple(range(-1, 102))),
        ("shadow, threshold 0", spec, model, kms.zero_tparams(spec, threshold=0), None),
        ("enforce, threshold 0", spec, model, kms.zero_tparams(spec, threshold=0, enforce=True),
         None),
    ]
    limit = kms.smem_limit(torch.device(DEV))
    checked, runs = 0, 0

    def check(sp, m, tp, batches, **kw):
        """One configuration on plan_for's plan, then each plan forced (S
        where it fits)."""
        nonlocal checked, runs
        b = batches[0][0].shape[0]
        for plan in [None] + (["S"] if kms.block_plan_bytes(b, sp) <= limit else []) + ["L"]:
            runs += 1 + k10_check(kms, sp, m, tp, batches, seed=checked, plan=plan, **kw)
        checked += 1

    for label, sp, m, tp, tenants in configs:
        for b in K10_SIZES:
            for name in ("synflood", "uniform"):
                for resident in (False, True):
                    check(sp, m, tp, draws(b, name, tenants=tenants), resident=resident)
    for resident in (False, True):
        check(spec, model, kms.zero_tparams(spec, 0, True), draws(4096, "uniform", width=4),
              resident=resident)
    sat40 = kms.ScoreSpec.make(sat=40, slots=32, ways=2, cms_width=64, hidden=8)
    start = {k: np.asarray(v).copy() for k, v in zip(kms.ScoreState._fields,
                                                    kms.zero_state_host(sat40))}
    start["cms"][:] = rng.integers(0, 200, start["cms"].shape)
    start["cms"][0, :4] = 2**31 - 1
    start["scols"][:, :4] = rng.integers(0, 200, (32, 4))
    start["scols"][:, 6] = rng.integers(0, 200, 32)
    start["scols"][:3, :4] = 2**31 - 1
    for resident in (False, True):
        check(sat40, kms.clamp_stress_model(sat40),
              kms.zero_tparams(sat40, threshold=50, enforce=True), draws(300, "synflood"),
              resident=resident, start=start)
    log(f"K10 vs plain: {checked} configurations (both entries at B = {list(K10_SIZES)} on the "
        f"synflood and uniform traces: {[c[0] for c in configs]}; the 4-word wire; a start state "
        f"above sat 40), each on plan_for's plan and on each plan forced (S where it fits): "
        f"{runs} runs of 2-3 chained admissions, every state tensor and output word equal, one "
        f"launch a call, the slot scratch back at -1 / 0; {time.perf_counter() - t0:.1f} s")

    # 2. bench_mlscore's cell through the classifiers
    t0 = time.perf_counter()
    bs = MLSCORE_CHUNK
    trace, meta = testing.attack_trace_batch(np.random.default_rng(1400), tables,
                                             bs * MLSCORE_CHUNKS, "synflood", chunk_packets=bs)
    tflags = np.asarray(trace.tcp_flags, np.int32)
    chunks = []
    for lo in range(0, len(trace), bs):
        sub = np.arange(lo, lo + bs, dtype=np.int64)
        w, v4 = trace.pack_wire_subset(sub)
        chunks.append((w, v4, np.ascontiguousarray(tflags[sub])))
    ref = oracle.classify(tables, trace).results

    def admit(c, chunk):
        w, v4, f = chunk
        return c.classify_prepared(c.prepare_packed(w, v4, tcp_flags=f), apply_stats=False).result()

    def classifier(device, resident, mode):
        c = TorchClassifier(device=device, force_path="trie", resident=resident,
                            flow_table=FlowConfig.make(entries=1 << 14), mlscore=spec,
                            mlscore_model=model, mlscore_mode=mode)
        c.load_tables(tables)
        c.mlscore.set_keep_masks(len(chunks))
        return c

    cell = {}
    for mode in ("shadow", "enforce"):
        plans = {"resident": classifier(DEV, True, mode), "multi-dispatch": classifier(DEV, False, mode),
                 "plain (CPU)": classifier("cpu", True, mode)}
        outs, launches = {}, {}
        for label, c in plans.items():
            torch.cuda.synchronize()
            for k in kernels:
                k.launches = 0
            outs[label] = [admit(c, ch) for ch in chunks]
            launches[label] = {k.name: k.launches for k in kernels if k.launches}
        captures = plans["resident"].resident.graphs()
        lr, lm = launches["resident"], launches["multi-dispatch"]
        if (lr.get("score_update_resident", 0) != len(chunks) + captures or lr.get("score_update")
                or lm.get("score_update", 0) != len(chunks) or lm.get("score_update_resident")
                or launches["plain (CPU)"]):
            raise SystemExit(f"mlscore main path ({mode}): launches {launches}; expected "
                             f"{len(chunks)} + {captures} resident K10 calls, {len(chunks)} "
                             f"classic, none on the CPU")
        base = plans["resident"]
        for label, c in plans.items():
            for j, (a, b) in enumerate(zip(outs[label], outs["resident"])):
                if not (np.array_equal(a.results, b.results) and np.array_equal(a.xdp, b.xdp)
                        and np.array_equal(a.stats_delta, b.stats_delta)):
                    raise SystemExit(f"mlscore {mode}: the {label} plan's admission {j} differs "
                                     f"from the resident plan's")
            cols, bcols = c.mlscore.columns(), base.mlscore.columns()
            fl, bfl = c.flow.flow_columns(), base.flow.flow_columns()
            if not (all(np.array_equal(cols[f], bcols[f]) for f in cols)
                    and all(np.array_equal(fl[f], bfl[f]) for f in fl)):
                raise SystemExit(f"mlscore {mode}: the {label} plan's score or flow tensors "
                                 f"differ from the resident plan's")
            for (e1, a1, s1), (e2, a2, s2) in zip(c.mlscore.recent_masks(),
                                                  base.mlscore.recent_masks()):
                if e1 != e2 or not np.array_equal(a1, a2) or not np.array_equal(s1, s2):
                    raise SystemExit(f"mlscore {mode}: the {label} plan's scores differ")
        got = np.concatenate([o.results for o in outs["resident"]])
        anom = np.concatenate([a for _e, a, _s in base.mlscore.recent_masks()])
        if mode == "shadow":
            if not np.array_equal(got, ref):
                raise SystemExit(f"mlscore shadow: {int((got != ref).sum())} verdicts differ "
                                 f"from the oracle's")
        else:
            fs = kms.failsafe_lane_mask_np(trace.proto, trace.dst_port)
            rewritten = got != ref
            if (rewritten & ((got != 1) | fs)).any() or not rewritten.any():
                raise SystemExit("mlscore enforce: a rewrite is not a Deny with ruleId 0, or "
                                 "lands on a failsafe cell, or nothing was rewritten")
            truth = np.asarray(meta["attack_mask"], bool)
            post = np.arange(len(trace)) >= meta["start"]
            cell["mitigated"] = float((got[truth & post] == 1).mean())
            base.mlscore.drain()
            cell["enforced"] = base.mlscore.counter_values()["mlscore_enforced_total"]
            # failsafe precedence with everything anomalous (bench.py:4362-4383)
            base.mlscore.set_threshold(-(10**6))
            fsb = testing.random_batch_fast(np.random.default_rng(9), tables, bs)
            fsb.kind[:] = 1
            fsb.l4_ok[:] = 1
            fsb.proto[:] = 6
            fs_ports = np.asarray([22, 6443, 2379, 2380, 10250, 10257, 10259], np.int32)
            fsb.dst_port[:] = fs_ports[np.arange(bs) % len(fs_ports)]
            fsb.tcp_flags = np.full(bs, 0x10, np.int32)
            w, v4 = fsb.pack_wire_subset(np.arange(bs, dtype=np.int64))
            o = admit(base, (w, v4, fsb.tcp_flags))
            if not np.array_equal(o.results, oracle.classify(tables, fsb).results):
                raise SystemExit("mlscore enforce: a failsafe cell lost its rule verdict")
        cell[mode] = {"launches": launches, "captures": captures,
                      "anomalous_lanes": int(anom.sum())}
        if mode == "shadow":
            # a model swap and two mode flips: the flow generation bumps, no capture
            g0, a0 = base.resident.graphs(), base.resident_counters()["resident_allocs_total"]
            gen0 = int(base.flow._gens_host[0])
            base.set_score_model(model._replace(version="v2"))
            base.mlscore.set_mode("enforce")
            base.mlscore.set_mode("shadow")
            for ch in chunks[:8]:
                admit(base, ch)
            g1, a1 = base.resident.graphs(), base.resident_counters()["resident_allocs_total"]
            gen1 = int(base.flow._gens_host[0])
            if (g1, a1, gen1) != (g0, a0, gen0 + 3):
                raise SystemExit(f"mlscore: swap and flips moved graphs {g0} -> {g1}, allocs "
                                 f"{a0} -> {a1}, generation {gen0} -> {gen1}")
            cell["swap"] = {"graphs": g1, "allocs": a1, "generation_bumps": gen1 - gen0}
        for c in plans.values():
            c.close()
    detect = {}
    for mode in ("synflood", "portscan"):
        dtrace, dmeta = testing.attack_trace_batch(np.random.default_rng(1400), tables,
                                                   bs * MLSCORE_CHUNKS, mode, chunk_packets=bs)
        dflags = np.asarray(dtrace.tcp_flags, np.int32)
        det = TorchClassifier(device=DEV, force_path="trie", resident=True,
                              flow_table=FlowConfig.make(entries=1 << 14), mlscore=spec,
                              mlscore_model=model)
        det.load_tables(tables)
        srcs = {".".join(str(x) for x in int(s[0]).to_bytes(4, "big")) if k == 1 else "v6"
                for s, k in dmeta["attackers"]}
        start = dmeta["start"] // bs
        for ci in range(len(dtrace) // bs):
            sub = np.arange(ci * bs, (ci + 1) * bs, dtype=np.int64)
            w, v4 = dtrace.pack_wire_subset(sub)
            admit(det, (w, v4, np.ascontiguousarray(dflags[sub])))
            if ci < start:
                continue
            rec = det.mlscore.drain(force=True)[0]
            if any(h["src"] in srcs for h in rec.top):
                detect[mode] = ci - start + 1
                break
        else:
            raise SystemExit(f"mlscore: the {mode} attacker never surfaced in a drained record")
        det.close()
    log(f"{tag} mlscore main path (bench_mlscore's cell, {len(chunks)} admissions of {bs}): "
        f"launches {cell['shadow']['launches']} (shadow), {cell['enforce']['launches']} "
        f"(enforce); resident, multi-dispatch and the CPU's plain versions equal (verdicts, XDP, "
        f"statistics, score and flow tensors, scores); shadow verdicts equal the oracle's; "
        f"enforce: {cell['mitigated']:.4f} of post-onset attack lanes denied, "
        f"{cell['enforced']} rewrites, every one a Deny with ruleId 0 off the failsafe cells, "
        f"failsafe cells keep their rule verdicts; a swap and two flips: {cell['swap']}; a drained "
        f"record names the attacker after {detect['synflood']} (synflood) and "
        f"{detect['portscan']} (portscan) admissions from the onset; "
        f"{time.perf_counter() - t0:.1f} s")

    # 3. K10's times and the resident admission on and off
    timings = {}
    for b in K10_TIMED:
        for name, args in k9_traces(tables, b).items():
            o_k, o_p = k10_ops(kms, spec, model), k10_ops(kms, spec, model)
            args = [x.to(DEV) for x in args]
            fn = lambda: kms.score_update(o_k, *args)  # noqa: E731
            timings[f"{name} {b}"] = {
                "plan": kms.plan_for(b, spec, limit),
                "ms": cuda_ms(fn, reps=20), "paced_ms": device_paced_ms(fn, reps=20),
                "plain_ms": cuda_ms(lambda: kms.score_update_out_plain(o_p, *args), reps=3,
                                    warmup=1),
                "bound_ms": k10_bytes(spec, b, 7) / HBM_BYTES_PER_S * 1e3,
            }
            if "score_update" in PARENT_KERNELS:
                timings[f"{name} {b}"]["parent_in_turns"] = k10_parent_turns(
                    tag, kms, spec, model, args, f"{name} {b}")
    child = finish_child(profile, "K10 profile child")
    prof = json.loads(child.strip().splitlines()[-1])
    for key, t in timings.items():
        p = prof["k10"][key]
        t.update(device_us=p["device_us"], kernels=p["kernels"], per_kernel_us=p["per_kernel_us"])
        dev_ms = t["device_us"] / 1e3 if t["device_us"] else None
        log(f"{tag} K10 score_update [{key}], plan {t['plan']}: events {t['ms']:.5f} ms, with the "
            f"host ahead "
            f"{t['paced_ms']:.5f} ms, device {t['device_us'] if t['device_us'] else 'lost'} us "
            f"({t['per_kernel_us']}); bound {t['bound_ms']:.6f} ms by bytes"
            + (f" ({dev_ms / t['bound_ms']:.2f}x)" if dev_ms else "")
            + f"; plain {t['plain_ms']:.4f} ms")
    # the crossover: both plans over a ladder of sizes, in a fresh process
    child = run_child([sys.executable, "-m", "infw_torch.tools.score_plans", "--sizes",
                       ",".join(str(b) for b in K10_LADDER)], "K10 plan ladder")
    for line in child.stdout.strip().splitlines()[:-1]:
        log(f"{tag} {line}")
    ladder = json.loads(child.stdout.strip().splitlines()[-1])
    log(f"{tag} K10 crossover: plan S no slower than plan L on both traces up to B = "
        f"{ladder['crossover']} of the ladder; plan_for's crossover {kms.BLOCK_PLAN_MAX_LANES}")
    adm = prof["admission"]
    ratio = (adm["on"]["device_us"] / adm["off"]["device_us"]
             if adm["on"]["device_us"] and adm["off"]["device_us"] else None)
    log(f"{tag} resident admission (4096 packets, synflood, bench_mlscore's tables) device time: "
        f"scoring on {adm['on']['device_us']} us in {adm['on']['kernels']} kernels, off "
        f"{adm['off']['device_us']} us in {adm['off']['kernels']} kernels ({ratio}x); copies "
        f"{adm['on']['h2d']} / {adm['on']['d2h']} on, {adm['off']['h2d']} / {adm['off']['d2h']} "
        f"off")

    # 4. the daemon with --resident --mlscore, a model dropped into models/
    st = FLOW_STASH
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "mlscore-smoke")
    shutil.rmtree(root, ignore_errors=True)
    d = daemon.Daemon(state_dir=os.path.join(root, "state"), node_name=DAEMON_NODE,
                      registry=st["daemon_registry"], metrics_port=0, health_port=0,
                      poll_period_s=0.1, file_poll_interval_s=0.02,
                      flow_table=FlowConfig.make(entries=FLOW_SLAB), resident=True,
                      mlscore=(spec, model), mlscore_mode="shadow",
                      backend="cuda" if DEV == "cuda" else "cpu")
    daemon_launches, passes = {}, []
    try:
        d.start()
        p = os.path.join(d.nodestates_dir, f"{DAEMON_NODE}.json")
        with open(p + ".tmp", "w") as f:
            json.dump(st["daemon_doc"], f)
        os.replace(p + ".tmp", p)
        _wait(lambda: d.syncer.classifier is not None and d.syncer.classifier.tables is not None
              and bool(d.syncer.attached_interfaces()), "the mlscore daemon's NodeState", 300)
        c = d.syncer.classifier
        _wait(lambda: id(c.mlscore) in d._mlscore_attached, "the mlscore daemon's attach", 60)
        fb = st["daemon_fb"]
        stage_dir = os.path.join(d.state_dir, "staging")
        os.makedirs(stage_dir, exist_ok=True)
        gen0 = None
        for k in range(2):
            daemon.write_frames_file_v2(os.path.join(stage_dir, f"{k}.frames"), fb)
            torch.cuda.synchronize()
            for kern in kernels:
                kern.launches = 0
            t = time.perf_counter()
            os.replace(os.path.join(stage_dir, f"{k}.frames"),
                       os.path.join(d.ingest_dir, f"{k}.frames"))
            _wait(lambda: os.path.exists(os.path.join(d.out_dir, f"{k}.frames.verdicts.json")),
                  "the mlscore daemon's pass", 600, 0.002)
            dt = time.perf_counter() - t
            daemon_launches[f"mlscore {k}"] = {x.name: x.launches for x in kernels if x.launches}
            got = open(os.path.join(d.out_dir, f"{k}.frames.verdicts.bin"), "rb").read()
            if got != st["daemon_stateless"]:
                raise SystemExit(f"mlscore daemon: pass {k}'s verdict file differs from the "
                                 f"stateless daemon's")
            if daemon_launches[f"mlscore {k}"].get("score_update_resident", 0) <= 0:
                raise SystemExit(f"mlscore daemon: launches {daemon_launches}")
            passes.append({"s": dt, "graphs": c.resident.graphs(),
                           "allocs": c.resident_counters()["resident_allocs_total"]})
            if k == 0:
                gen0 = int(c.flow._gens_host[0])
                ml.save_model(model._replace(version="dropped"),
                              os.path.join(d.models_dir, "m1.npz"))
                _wait(lambda: c.mlscore_counters()["mlscore_model_swaps_total"] == 1,
                      "the mlscore daemon's model swap", 60)
        gen1 = int(c.flow._gens_host[0])
        if (c.mlscore.model_version != "dropped" or gen1 != gen0 + 1 or os.listdir(d.models_dir)
                or (passes[1]["graphs"], passes[1]["allocs"]) != (passes[0]["graphs"],
                                                                  passes[0]["allocs"])):
            raise SystemExit(f"mlscore daemon: after the swap version {c.mlscore.model_version}, "
                             f"generation {gen0} -> {gen1}, models/ {os.listdir(d.models_dir)}, "
                             f"passes {passes}")
        _wait(lambda: c.mlscore_counters()["mlscore_window_admissions"] == 0,
              "the mlscore daemon's last window to drain", 60)
        mc = c.mlscore_counters()
        for key in ("mlscore_updates_total", "mlscore_model_swaps_total", "mlscore_drains_total",
                    "mlscore_admissions_total", "mlscore_anomalies_total"):
            if _metric(d, key) != mc[key]:
                raise SystemExit(f"mlscore daemon: /metrics {key} {_metric(d, key)} is not the "
                                 f"classifier's {mc[key]}")
        d.events_logger.drain_once()
        records = [ln for ln in open(d.events_path).read().splitlines()
                   if ln.startswith("anomaly-verdict ")]
        if len(records) != mc["mlscore_drain_seq"] or not records:
            raise SystemExit(f"mlscore daemon: {len(records)} anomaly-verdict lines for "
                             f"{mc['mlscore_drain_seq']} drains")
        log(f"{tag} mlscore daemon (--resident --mlscore): 2 passes of {len(fb)} frames in "
            f"{passes[0]['s']:.3f} / {passes[1]['s']:.3f} s, launches {daemon_launches}; verdict "
            f"files equal to the stateless daemon's; a model dropped into models/ between them "
            f"swapped (generation {gen0} -> {gen1}, graphs {passes[0]['graphs']} and allocs "
            f"{passes[0]['allocs']} unchanged by the second pass); mlscore_* on /metrics equal to "
            f"the classifier's {mc}; {len(records)} anomaly-verdict records in events.log")
    finally:
        d.stop()
    shutil.rmtree(root, ignore_errors=True)

    main = timings[f"synflood {MLSCORE_CHUNK}"]
    return {
        "name": "score_update", "route": "cuda",
        "source": "infw_torch/kernels/csrc/score_update.cu",
        "replaces": "infw/kernels/mxu_score.py:734",
        "launches": cell["shadow"]["launches"]["resident"].get("score_update_resident", 0),
        "mismatches": 0, "max_abs_err": 0,
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "entries": {"classic": "score_update", "resident": "score_update_resident"},
        "checked_configurations": checked, "checked_runs": runs, "timings": timings,
        "plans": {key: t["plan"] for key, t in timings.items()},
        "plan_ladder": ladder["sizes"], "crossover_measured": ladder["crossover"],
        "admission": adm, "admission_on_off": ratio, "cell": cell, "detect_admissions": detect,
        "mlscore_daemon_launches": daemon_launches, "daemon_passes": passes,
    }


PAYLOAD_CHUNK, PAYLOAD_CHUNKS = 256, 40
#: the card tests' grid of K11 automata: pattern count, matmul (-> S, PW):
#: 8 (64 states, 1 word, a matmul spec), 64 (1024, 2), 1024 (16384, 32), 2048 (32768, 64)
K11_GRID = {"S 64, PW 1, matmul": (8, True), "S 1024, PW 2": (64, False),
            "S 16384, PW 32": (1024, False), "PW 64": (2048, False)}
K11_SIZES, K11_TIMED = (1, 31, 33, 256, 4096, 1 << 18), (256, 4096, 1 << 18)
#: K11's plan ladder: one size either side of the measured crossover (for the
#: script's time)
K11_PLAN_LADDER = (1 << 17, 196608)
#: bench_payload's automaton ladder (bench.py:4576-4602): patterns x prefix bytes at B = 256
K11_LADDER = (64, 256, 1024)
_K11_MODELS: dict = {}


def k11_model(count: int, plen: int, matmul=None, seed=None):
    """The compiled signature set of ``count`` patterns (seed ``count``, or
    ``seed``), cached: the grid, the ladder and the cell share them."""
    from infw_torch import payload as ppay
    from infw_torch.kernels import acmatch as kac

    key = (count, plen, matmul, seed)
    if key not in _K11_MODELS:
        pats = ppay.signature_patterns(np.random.default_rng(count if seed is None else seed),
                                       count, plen)
        _K11_MODELS[key] = kac.compile_patterns(pats, plen=plen, matmul=matmul)
    return _K11_MODELS[key]


def payload_mix(prng, n: int, pats, plen: int, attack_frac: float = 0.1):
    """bench_payload's traffic (bench.py:4505-4516): benign HTTP prefixes with
    a planted-signature minority, shuffled -> (pay (n, plen) uint8, lengths
    (n,) int32)."""
    from infw_torch import payload as ppay

    k = max(1, int(n * attack_frac))
    pay_a, len_a = ppay.attack_payloads(prng, k, pats, plen=plen)
    pay_b, len_b = ppay.benign_payloads(prng, n - k, plen=plen)
    perm = prng.permutation(n)
    return (np.ascontiguousarray(np.concatenate([pay_a, pay_b])[perm]),
            np.ascontiguousarray(np.concatenate([len_a, len_b])[perm].astype(np.int32)))


def k11_columns(rng, model, b: int, kind: str):
    """K11's inputs at any size: "synflood" rows (8 of 10 with no payload,
    the rest a few junk bytes) or the "attack" mix (bench_payload's, tiled
    from a block of 2048 rows, with the length edge cases in front)."""
    L = model.spec.plen
    if kind == "synflood":
        pay = np.zeros((b, L), np.uint8)
        pay[:, :8] = rng.integers(0, 256, (b, 8), dtype=np.uint8)
        lens = np.where(rng.random(b) < 0.8, 0, rng.integers(1, 9, b)).astype(np.int32)
        return pay, lens
    n = min(b, 2048)
    bp, bl = payload_mix(rng, n, model.patterns, L)
    reps = -(-b // n)
    pay = np.ascontiguousarray(np.tile(bp, (reps, 1))[:b])
    lens = np.tile(bl, reps)[:b].astype(np.int32)
    edge = np.asarray([0, -1, L + 1, 2**31 - 1, L, L - 1, -2**31, 1], np.int32)
    lens[: min(b, 8)] = edge[: min(b, 8)]
    return pay, lens


def k11_walk_reads(model, pay, plen):
    """A replay of K11's walk in numpy -> (the (state, byte) entries of
    ``delta`` it reads, the states whose matchmap rows it reads)."""
    S, L = model.spec.states, model.spec.plen
    data = np.asarray(pay, np.uint8)[:, :L].astype(np.int64)
    n = np.clip(np.asarray(plen, np.int64), 0, L)
    delta = np.asarray(model.delta, np.int64)
    state = np.zeros(data.shape[0], np.int64)
    codes, landed = [], []
    for p in range(L):
        act = n > p
        if not act.any():
            break
        s, c = np.clip(state[act], 0, S - 1), data[act, p]
        codes.append(np.unique(s * 256 + c))
        nxt = np.clip(delta[s, c], 0, S - 1)
        state[act] = nxt
        landed.append(np.unique(nxt))
    codes = np.unique(np.concatenate(codes)) if codes else np.zeros(0, np.int64)
    land = np.unique(np.concatenate(landed)) if landed else np.zeros(0, np.int64)
    return {(int(x) >> 8, int(x) & 255) for x in codes}, {int(x) for x in land}


def k11_bound_bytes(model, pay, plen) -> int:
    """What the match must move: each lane's active payload bytes, its
    length and its PW bitmap words once, and each delta entry and matchmap
    row the walks read once (this run's data, k11_walk_reads)."""
    L, PW = model.spec.plen, model.spec.pwords
    b = np.asarray(pay).shape[0]
    active = int(np.clip(np.asarray(plen, np.int64), 0, L).sum())
    entries, landed = k11_walk_reads(model, pay, plen)
    return active + 4 * b + 4 * PW * b + 4 * len(entries) + 4 * PW * len(landed)


def k11_resident_words(rng, b: int):
    """The resident entry's other operands on the card: a (b, 7) wire
    (failsafe ports among them), the probe's words, its hit bitmap and the
    stateless words."""
    import torch

    from infw_torch.kernels.flow import pack_bits32
    from infw_torch.kernels.torchpath import _pack_res16

    proto = rng.choice([6, 17, 1], b).astype(np.uint32)
    dport = rng.choice([22, 68, 80, 443, 2379, 10250], b).astype(np.uint32)
    wire = np.zeros((b, 7), np.uint32)
    wire[:, 0] = 1 | (1 << 2) | (proto << 3)
    wire[:, 1] = dport
    res = rng.integers(0, 3, b) | (rng.integers(0, 9, b) << 8)
    hit_m = rng.random(b) < 0.4
    return (torch.from_numpy(wire.view(np.int32)).to(DEV),
            _pack_res16(torch.from_numpy(np.where(hit_m, res, 7))).to(DEV),
            pack_bits32(torch.from_numpy(hit_m)).to(DEV),
            _pack_res16(torch.from_numpy(np.where(hit_m, 5, res))).to(DEV))


def k11_check(kac, model, pay_np, lens_np, rng, label: str) -> int:
    """K11 on the card against its plain version (plain PyTorch on the same
    card tensors): the classic entry's bitmaps, and the resident entry's
    word vectors and tail in shadow and enforce from random probe words, hit
    bitmap, stateless words and wire (failsafe ports among them); one launch
    a call.  Raises on a mismatch; returns the largest absolute difference
    (0)."""
    import torch

    dev = kac.model_device(model, DEV)
    pay, lens = torch.from_numpy(pay_np).to(DEV), torch.from_numpy(lens_np).to(DEV)
    b = pay.shape[0]
    before = kac.KERNEL.launches
    got = kac.acmatch(dev, pay, lens, model.spec)
    want = kac.acmatch_plain(dev, pay, lens, model.spec)
    torch.cuda.synchronize()
    if kac.KERNEL.launches != before + 1:
        raise SystemExit(f"K11: {kac.KERNEL.launches - before} launches in one call")
    if not torch.equal(got, want):
        raise SystemExit(f"K11 classic entry disagrees with its plain version [{label}]")
    wire_t, *words = k11_resident_words(rng, b)
    nh = -(-b // 32)
    for mode in (0, 1):
        ops = kac.PayloadOps(dev, torch.tensor([mode], dtype=torch.int32, device=DEV),
                             model.spec, pay, lens)
        outs = []
        for fn in (kac.acmatch_resident, kac.acmatch_resident_plain):
            s, r = words[0].clone(), words[2].clone()
            tail = torch.full((2 * nh,), -1, dtype=torch.int32, device=DEV)
            fn(ops, wire_t, s, words[1], r, tail)
            outs.append((s, r, tail))
        torch.cuda.synchronize()
        for name, x, y in zip(("served", "res16", "tail"), *outs):
            if not torch.equal(x, y):
                raise SystemExit(f"K11 resident entry disagrees with its plain version on {name} "
                                 f"[{label}, {'enforce' if mode else 'shadow'}]")
    return 0


def k11_parent_turns(tag: str, kac, model, b: int) -> dict:
    """--parent's K11 against this tree's on bench_payload's mix at ``b``
    lanes: both entries' outputs equal (the resident one in enforce mode),
    then each entry with the host ahead in turns (parent, this, this,
    parent).  A parent of the first design takes the dense DFA and no launch
    shape.  Returns {entry: {"paced_ms": this tree's mean, "parent_paced_ms":
    the parent's}}."""
    import torch

    spec = model.spec
    d = kac.model_device(model, DEV)
    pay_np, lens_np = k11_columns(np.random.default_rng(b), model, b, "attack")
    pay, lens = torch.from_numpy(pay_np).to(DEV), torch.from_numpy(lens_np).to(DEV)
    wire, served, hit, res16 = k11_resident_words(np.random.default_rng(b + 1), b)
    ops = kac.PayloadOps(d, torch.ones(1, dtype=torch.int32, device=DEV), spec, pay, lens)
    nh = -(-b // 32)
    old = k11_first_design(PARENT_KERNELS["payload_match"].csrc)
    lp = kac._plan(b, spec, torch.device(DEV), None, None)
    ptr = lambda *ts: tuple(t.data_ptr() for t in ts)  # noqa: E731
    model_ptrs = ptr(d.delta, d.matchmap) if old else ptr(d.next, d.mrows, d.head)
    shape = ((spec.plen, pay.shape[1], spec.states, spec.pwords) if old
             else kac._shape_args(lp, spec, pay))
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    out = torch.empty((b, spec.pwords), dtype=torch.int32, device=DEV)
    bufs = [served.clone(), res16.clone(), torch.empty(2 * nh, dtype=torch.int32, device=DEV)]

    def parent_classic():
        PARENT_KERNELS["payload_match"].launch(*model_ptrs, *ptr(pay, lens, out), b, *shape,
                                               stream())
        return out

    def parent_resident(s, r, t):
        PARENT_KERNELS["payload_match_resident"].launch(
            *model_ptrs, *ptr(pay, lens, ops.pmode, wire, s, hit, r, t), b, 7, *shape, stream())

    mine = kac.acmatch(d, pay, lens, spec)
    theirs = parent_classic().clone()
    outs = []
    for fn in (kac.acmatch_resident, None):
        x = [served.clone(), res16.clone(), torch.full((2 * nh,), -1, dtype=torch.int32,
                                                       device=DEV)]
        if fn is None:
            parent_resident(*x)
        else:
            fn(ops, wire, x[0], hit, x[1], x[2])
        outs.append(x)
    torch.cuda.synchronize()
    if not (torch.equal(mine, theirs) and all(torch.equal(x, y) for x, y in zip(*outs))):
        raise SystemExit(f"--parent's K11 disagrees with this tree's [B {b}]")
    fns = {"classic": (lambda: kac.acmatch(d, pay, lens, spec), parent_classic),
           "resident": (lambda: kac.acmatch_resident(ops, wire, bufs[0], hit, bufs[1], bufs[2]),
                        lambda: parent_resident(*bufs))}
    res = {}
    for entry, (this_fn, parent_fn) in fns.items():
        p1, t1, t2, p2 = (device_paced_ms(fn, reps=20)
                          for fn in (parent_fn, this_fn, this_fn, parent_fn))
        log(f"{tag} parent vs this tree [K11 {entry} entry, B {b}, 64 patterns x 64 B, attack "
            f"mix], with the host ahead, in turns: parent {p1:.5f}, {p2:.5f} ms; this {t1:.5f}, "
            f"{t2:.5f} ms; this / parent {(t1 + t2) / (p1 + p2):.3f}")
        res[entry] = {"paced_ms": (t1 + t2) / 2, "parent_paced_ms": (p1 + p2) / 2}
    return res


def k11_profile_child() -> None:
    """Run in a fresh process by the payload phase: K11's kernels and device
    microseconds per call at each timed size (bench_payload's 64 patterns x
    64 B, its attack mix), and one resident admission of 4096 packets with
    the payload tier on and off, printed as one JSON line."""
    import torch

    from infw_torch import layout, testing
    from infw_torch.backend.cuda import TorchClassifier
    from infw_torch.flow import FlowConfig
    from infw_torch.kernels import acmatch as kac

    model = k11_model(64, 64, seed=11)
    columns = {b: k11_columns(np.random.default_rng(b), model, b, "attack") for b in K11_TIMED}
    tables = mlscore_tables()
    batch = testing.random_batch_fast(np.random.default_rng(1500), tables, 4 * 4096)
    batch.tcp_flags = np.full(len(batch), 0x10, np.int32)
    batch.payload, batch.payload_len = payload_mix(np.random.default_rng(1503), len(batch),
                                                   model.patterns, 64)
    layout.build_poptrie(tables)  # the trie path's host layout, memoized for the loads
    wait_for_go()
    dev = kac.model_device(model, DEV)
    out = {"k11": {}, "admission": {}}
    for b in K11_TIMED:
        pay, lens = (torch.from_numpy(x).to(DEV) for x in columns[b])
        counts, rcounts = {}, {}
        dev_us = profiled_kernels(lambda: kac.acmatch(dev, pay, lens, model.spec), 10, counts)
        wire, served, hit, res16 = k11_resident_words(np.random.default_rng(b + 1), b)
        tail = torch.empty(2 * (-(-b // 32)), dtype=torch.int32, device=DEV)
        ops = kac.PayloadOps(dev, torch.ones(1, dtype=torch.int32, device=DEV), model.spec,
                             pay, lens)
        res_us = profiled_kernels(
            lambda: kac.acmatch_resident(ops, wire, served, hit, res16, tail), 10, rcounts)
        out["k11"][str(b)] = {"device_us": sum(dev_us.values()) if dev_us else None,
                              "kernels": counts, "per_kernel_us": dev_us,
                              "resident_device_us": sum(res_us.values()) if res_us else None,
                              "plan": kac.plan_for(b)}
    for label, pats in (("on", list(model.patterns)), ("off", None)):
        clf = TorchClassifier(device=DEV, force_path="trie", resident=True,
                              flow_table=FlowConfig.make(entries=1 << 14), payload=pats)
        clf.load_tables(tables)
        for lo in range(0, 3 * 4096, 4096):
            clf.classify(batch.slice(lo, lo + 4096), apply_stats=False)
        sub = batch.slice(3 * 4096, 4 * 4096)
        out["admission"][label] = admission_profile(lambda: clf.classify(sub, apply_stats=False))
    torch.cuda.synchronize()
    print(json.dumps(out), flush=True)


def payload_phase(tag: str) -> dict:
    """The payload tier (ROADMAP item 14) on the card; returns K11's
    kernels-line entry.

    1. K11 against its plain version through both entries over the card
       tests' grid: S 64 (a matmul spec, PW 1), 1024 (PW 2), 16384 (PW 32)
       and a 64-word bitmap, L 64 and 128, B = 1, 31, 33, 256, 4096, 2^18,
       synflood-like and attack-mix columns with the length edge cases;
    2. bench_payload's cell (bench.py:4449-4640) through the entry points a
       user calls: 100K x 8, 40% IPv6, trie; 64 signature patterns x 64 B;
       40 chunks of 256 packets, a 10% attack mix; a 2^14 flow table;
       resident and multi-dispatch on the card and resident on the CPU,
       launch counts zeroed before and read after each: verdicts, XDP,
       statistics, payload counters and flow columns equal across the three,
       shadow verdicts equal to the oracle; the oracle gate (tracking on):
       the retained bitmaps of both card plans equal payload_match_ref, the
       served matched bits their any-bit; the enforce leg: every rewrite a
       Deny with ruleId 0 off the failsafe cells and rule Denies, the
       matched lanes denied; a pattern swap and two mode flips mid-stream:
       the flow generation bumps each time, 0 new captures, 0 allocations,
       and the next admissions equal the CPU's after the same steps;
    3. the ladder (64 / 256 / 1024 patterns x 64 / 128 B at B = 256) and
       K11's times at B = 256, 4096 and 2^18 (CUDA events, with the host
       ahead, the profiler's device time of both entries in a fresh
       process, the plain version, the bytes bound); with --parent, both
       entries in turns against the parent's K11 at those sizes; the chain
       floor (64 and 128 dependent shared-memory loads on one warp); both
       plans over a ladder of sizes either side of the crossover
       (infw_torch.tools.payload_plans); the resident admission at 4096
       with the tier on and off (the profiling child);
    4. the daemon with --resident --payload default over the flow phase's
       1M-frame file: verdict files equal to the stateless daemon's (frames
       carry no payload bytes); a pattern artifact dropped into patterns/
       between two passes swaps (the flow generation bumped, no graph
       captured by the second pass); payload_* on /metrics equal to the
       classifier's."""
    import shutil

    import torch

    from infw_torch import daemon, oracle, testing
    from infw_torch import payload as ppay
    from infw_torch.backend.cuda import TorchClassifier
    from infw_torch.flow import FlowConfig
    from infw_torch.kernels import acmatch as kac
    from infw_torch.kernels import all_kernels, mxu_score as kms

    # the profile child builds its host inputs while this phase runs
    profile = start_child("k11_profile_child")
    kernels = all_kernels()

    # 1. K11 against its plain version over the grid
    t0 = time.perf_counter()
    rng = np.random.default_rng(1510)
    checked = 0
    for label, (count, matmul) in K11_GRID.items():
        for plen in (64, 128):
            model = k11_model(count, plen, matmul=matmul or None)
            for b in K11_SIZES:
                for kind in ("synflood", "attack"):
                    pay, lens = k11_columns(rng, model, b, kind)
                    k11_check(kac, model, pay, lens, rng,
                              f"{label}, S {model.spec.states}, PW {model.spec.pwords}, L {plen}, "
                              f"B {b}, {kind}")
                    checked += 1
    log(f"K11 vs plain: {checked} configurations ({list(K11_GRID)} x L 64 / 128 x B = "
        f"{list(K11_SIZES)} x synflood / attack mix), both entries, the resident one in shadow "
        f"and enforce: every bitmap and word equal, one launch a call; "
        f"{time.perf_counter() - t0:.1f} s")

    # 2. bench_payload's cell through the classifiers
    t0 = time.perf_counter()
    tables = mlscore_tables()
    model = k11_model(64, 64, seed=11)
    pats = list(model.patterns)
    bs = PAYLOAD_CHUNK
    trace = testing.random_batch_fast(np.random.default_rng(1500), tables, bs * PAYLOAD_CHUNKS)
    trace.tcp_flags = np.full(len(trace), 0x10, np.int32)
    tpay, tlen = payload_mix(np.random.default_rng(1503), len(trace), pats, 64)
    fs_rows = np.arange(0, len(trace), 97)
    trace.kind[fs_rows], trace.l4_ok[fs_rows], trace.proto[fs_rows] = 1, 1, 6
    trace.dst_port[fs_rows] = 22  # failsafe cells with payload bytes
    ref = oracle.classify(tables, trace).results
    chunks = []
    for lo in range(0, len(trace), bs):
        sub = np.arange(lo, lo + bs, dtype=np.int64)
        w, v4 = trace.pack_wire_subset(sub)
        chunks.append((w, v4, np.ascontiguousarray(trace.tcp_flags[sub]),
                       np.ascontiguousarray(tpay[lo:lo + bs]), np.ascontiguousarray(tlen[lo:lo + bs])))

    def admit(c, chunk):
        w, v4, f, p, n = chunk
        return c.classify_prepared(c.prepare_packed(w, v4, tcp_flags=f, payload=p, payload_len=n),
                                   apply_stats=False).result()

    def classifier(device, resident, mode):
        c = TorchClassifier(device=device, force_path="trie", resident=resident,
                            flow_table=FlowConfig.make(entries=1 << 14), payload=pats,
                            payload_plen=64, payload_mode=mode)
        c.load_tables(tables)
        return c

    want_bitmap = kac.host_match_bitmap(model, tpay, tlen)
    cell = {}
    for mode in ("shadow", "enforce"):
        plans = {"resident": classifier(DEV, True, mode),
                 "multi-dispatch": classifier(DEV, False, mode),
                 "plain (CPU)": classifier("cpu", True, mode)}
        outs, launches = {}, {}
        for label, c in plans.items():
            torch.cuda.synchronize()
            for k in kernels:
                k.launches = 0
            outs[label] = [admit(c, ch) for ch in chunks]
            launches[label] = {k.name: k.launches for k in kernels if k.launches}
        captures = plans["resident"].resident.graphs()
        lr, lm = launches["resident"], launches["multi-dispatch"]
        if (lr.get("payload_match_resident", 0) != len(chunks) + captures
                or lr.get("payload_match") or lm.get("payload_match", 0) != len(chunks)
                or lm.get("payload_match_resident") or launches["plain (CPU)"]):
            raise SystemExit(f"payload main path ({mode}): launches {launches}; expected "
                             f"{len(chunks)} + {captures} resident K11 calls, {len(chunks)} "
                             f"classic, none on the CPU")
        base = plans["resident"]
        for label, c in plans.items():
            for j, (a, b) in enumerate(zip(outs[label], outs["resident"])):
                if not (np.array_equal(a.results, b.results) and np.array_equal(a.xdp, b.xdp)
                        and np.array_equal(a.stats_delta, b.stats_delta)):
                    raise SystemExit(f"payload {mode}: the {label} plan's admission {j} differs "
                                     f"from the resident plan's")
            fl, bfl = c.flow.flow_columns(), base.flow.flow_columns()
            if (c.payload_counters() != base.payload_counters()
                    or not all(np.array_equal(fl[f], bfl[f]) for f in fl)):
                raise SystemExit(f"payload {mode}: the {label} plan's counters or flow columns "
                                 f"differ from the resident plan's")
        got = np.concatenate([o.results for o in outs["resident"]])
        hit = want_bitmap.any(axis=1)
        counters = base.payload_counters()
        if counters["payload_matched_total"] != int(hit.sum()):
            raise SystemExit(f"payload {mode}: {counters['payload_matched_total']} matched lanes, "
                             f"the naive reference {int(hit.sum())}")
        if mode == "shadow":
            if not np.array_equal(got, ref):
                raise SystemExit(f"payload shadow: {int((got != ref).sum())} verdicts differ from "
                                 f"the oracle's")
        else:
            fs = kms.failsafe_lane_mask_np(trace.proto, trace.dst_port)
            deny = (ref & 0xFF) == 1
            rw = hit & ~fs & ~deny
            if (not rw.any() or not (got[rw] == 1).all()
                    or not np.array_equal(got[~rw], ref[~rw]) or not (hit & fs).any()):
                raise SystemExit("payload enforce: a matched lane was not denied with ruleId 0, "
                                 "or a failsafe cell, a rule Deny or an unmatched lane changed")
            cell["enforced"] = counters["payload_enforced_total"]
        # the oracle gate: tracking on, both card plans, a subset of the chunks
        for label in ("resident", "multi-dispatch"):
            c = plans[label]
            c.payload.set_keep_masks(4)
            for ch in chunks[:4]:
                admit(c, ch)
            for pay, plen, bitmap, served_hit in c.payload.recent_masks():
                want = kac.host_match_bitmap(model, pay, plen)
                if not (np.array_equal(bitmap, want)
                        and np.array_equal(served_hit, want.any(axis=1))):
                    raise SystemExit(f"payload oracle gate ({label}, {mode}): a bitmap or the "
                                     f"served matched bits differ from payload_match_ref")
            c.payload.set_keep_masks(0)
        cell[mode] = {"launches": launches, "captures": captures,
                      "matched_lanes": counters["payload_matched_total"]}
        if mode == "shadow":
            # a swap and two mode flips mid-stream: 0 captures, 0 allocations
            cpu = plans["plain (CPU)"]
            base.mark_resident_warm()
            g0, a0 = base.resident.graphs(), base.resident_counters()["resident_allocs_total"]
            gen0 = int(base.flow._gens_host[0])
            other = ppay.signature_patterns(np.random.default_rng(12), 64, 64)
            steps = [lambda c: c.set_payload_patterns(other),
                     lambda c: c.set_payload_mode("enforce"),
                     lambda c: c.set_payload_mode("shadow")]
            for j, step in enumerate(steps):
                for c in (base, cpu):
                    step(c)
                for ch in chunks[4 * j: 4 * j + 4]:
                    a, b = admit(base, ch), admit(cpu, ch)
                    if not (np.array_equal(a.results, b.results)
                            and np.array_equal(a.stats_delta, b.stats_delta)):
                        raise SystemExit(f"payload: after step {j} of the swap and flips the "
                                         f"card and the CPU differ")
            g1, a1 = base.resident.graphs(), base.resident_counters()["resident_allocs_total"]
            gen1 = int(base.flow._gens_host[0])
            if (g1, a1, gen1, base.resident.steady_allocs()) != (g0, a0, gen0 + 3, 0):
                raise SystemExit(f"payload: swap and flips moved graphs {g0} -> {g1}, allocs "
                                 f"{a0} -> {a1}, generation {gen0} -> {gen1}")
            cell["swap"] = {"graphs": g1, "new_captures": g1 - g0, "allocs": a1 - a0,
                            "generation_bumps": gen1 - gen0}
        for c in plans.values():
            c.close()
    log(f"{tag} payload main path (bench_payload's cell, {len(chunks)} admissions of {bs}, "
        f"64 patterns x 64 B, {model.spec}): launches {cell['shadow']['launches']} (shadow), "
        f"{cell['enforce']['launches']} (enforce); resident, multi-dispatch and the CPU's plain "
        f"versions equal (verdicts, XDP, statistics, payload counters, flow columns); shadow "
        f"verdicts equal the oracle's; {cell['shadow']['matched_lanes']} matched lanes as the "
        f"naive reference; the oracle gate clean on both card plans; enforce: {cell['enforced']} "
        f"rewrites, every matched lane off the failsafe cells and rule Denies a Deny with ruleId "
        f"0, the rest unchanged; a swap and two flips mid-stream: {cell['swap']}; "
        f"{time.perf_counter() - t0:.1f} s")

    # 3. the ladder, K11's times and the resident admission on and off
    t0 = time.perf_counter()
    timings, ladder = {}, {}

    def timed(m, b, key, store):
        pay_np, lens_np = k11_columns(np.random.default_rng(b), m, b, "attack")
        d = kac.model_device(m, DEV)
        pay, lens = torch.from_numpy(pay_np).to(DEV), torch.from_numpy(lens_np).to(DEV)
        fn = lambda: kac.acmatch(d, pay, lens, m.spec)  # noqa: E731
        store[key] = {
            "ms": cuda_ms(fn, reps=20), "paced_ms": device_paced_ms(fn, reps=20),
            "plain_ms": cuda_ms(lambda: kac.acmatch_plain(d, pay, lens, m.spec), reps=3, warmup=1),
            "bound_ms": k11_bound_bytes(m, pay_np, lens_np) / HBM_BYTES_PER_S * 1e3,
            "spec": list(m.spec),
        }

    for count in K11_LADDER:
        for plen in (64, 128):
            m = k11_model(count, plen, seed=100 + count)
            timed(m, PAYLOAD_CHUNK, f"{count} x {plen}", ladder)
            t = ladder[f"{count} x {plen}"]
            log(f"{tag} K11 ladder [{count} patterns x {plen} B, S {m.spec.states}, PW "
                f"{m.spec.pwords}, B {PAYLOAD_CHUNK}]: events {t['ms']:.5f} ms, with the host "
                f"ahead {t['paced_ms']:.5f} ms ({PAYLOAD_CHUNK / t['paced_ms'] / 1e3:.3f} M "
                f"packets/s); bound {t['bound_ms']:.7f} ms by bytes; plain {t['plain_ms']:.4f} ms")
    for b in K11_TIMED:
        timed(model, b, str(b), timings)
    here = os.path.dirname(os.path.abspath(__file__))
    child = finish_child(profile, "K11 profile child")
    prof = json.loads(child.strip().splitlines()[-1])
    for key, t in timings.items():
        p = prof["k11"][key]
        t.update(device_us=p["device_us"], kernels=p["kernels"], per_kernel_us=p["per_kernel_us"],
                 resident_device_us=p["resident_device_us"], plan=p["plan"])
        dev_ms = t["device_us"] / 1e3 if t["device_us"] else None
        log(f"{tag} K11 payload_match [B {key}, 64 patterns x 64 B, attack mix], plan "
            f"{t['plan']}: events {t['ms']:.5f} ms, with the host ahead {t['paced_ms']:.5f} ms, "
            f"device {t['device_us'] if t['device_us'] else 'lost'} us ({t['per_kernel_us']}), "
            f"the resident entry {t['resident_device_us'] or 'lost'} us; bound "
            f"{t['bound_ms']:.7f} ms by bytes" + (f" ({dev_ms / t['bound_ms']:.1f}x)" if dev_ms
                                                  else "")
            + f"; plain {t['plain_ms']:.4f} ms")
    if "payload_match" in PARENT_KERNELS:
        for b in K11_TIMED:
            timings[str(b)]["parent"] = k11_parent_turns(tag, kac, model, b)
    # the chain floor: one warp's dependent shared-memory loads
    floor = {steps: kac.chain_floor(steps, torch.device(DEV)) for steps in (64, 128)}
    for steps, f in floor.items():
        ghz = f["clock_khz"] / 1e6
        log(f"{tag} K11 chain floor: {steps} dependent shared-memory loads on one warp, a "
            f"pointer chase: {f['chase_cycles']} cycles ({f['chase_cycles'] / steps:.1f} a load, "
            f"{f['chase_cycles'] / ghz / 1e3:.3f} us at the {ghz:.3f} GHz the card reports); "
            f"the walk's own step (index from a byte, a 16-bit load, the mask): "
            f"{f['step_cycles']} cycles ({f['step_cycles'] / steps:.1f} a step, "
            f"{f['step_cycles'] / ghz / 1e3:.3f} us)")
    # the crossover: both plans over a ladder of sizes, in a fresh process
    child = run_child([sys.executable, "-m", "infw_torch.tools.payload_plans", "--sizes",
                       ",".join(str(b) for b in K11_PLAN_LADDER)], "K11 plan ladder")
    for line in child.stdout.strip().splitlines()[:-1]:
        log(f"{tag} {line}")
    plans = json.loads(child.stdout.strip().splitlines()[-1])
    log(f"{tag} K11 crossover: plan S no slower than plan L on both entries up to B = "
        f"{plans['crossover']} of the ladder; plan_for's crossover {kac.STAGED_PLAN_MAX_LANES}")
    adm = prof["admission"]
    ratio = (adm["on"]["device_us"] / adm["off"]["device_us"]
             if adm["on"]["device_us"] and adm["off"]["device_us"] else None)
    log(f"{tag} resident admission (4096 packets, bench_payload's tables and mix) device time: "
        f"payload on {adm['on']['device_us']} us in {adm['on']['kernels']} kernels, off "
        f"{adm['off']['device_us']} us in {adm['off']['kernels']} kernels ({ratio}x); copies "
        f"{adm['on']['h2d']} / {adm['on']['d2h']} on, {adm['off']['h2d']} / {adm['off']['d2h']} "
        f"off; {time.perf_counter() - t0:.1f} s")

    # 4. the daemon with --resident --payload default, a set dropped into patterns/
    st = FLOW_STASH
    root = os.path.join(here, "build", "payload-smoke")
    shutil.rmtree(root, ignore_errors=True)
    default = ppay.signature_patterns(np.random.default_rng(0), 32, plen=64)
    d = daemon.Daemon(state_dir=os.path.join(root, "state"), node_name=DAEMON_NODE,
                      registry=st["daemon_registry"], metrics_port=0, health_port=0,
                      poll_period_s=0.1, file_poll_interval_s=0.02,
                      flow_table=FlowConfig.make(entries=FLOW_SLAB), resident=True,
                      payload=default, payload_mode="shadow",
                      backend="cuda" if DEV == "cuda" else "cpu")
    daemon_launches, passes = {}, []
    try:
        d.start()
        p = os.path.join(d.nodestates_dir, f"{DAEMON_NODE}.json")
        with open(p + ".tmp", "w") as f:
            json.dump(st["daemon_doc"], f)
        os.replace(p + ".tmp", p)
        _wait(lambda: d.syncer.classifier is not None and d.syncer.classifier.tables is not None
              and bool(d.syncer.attached_interfaces()), "the payload daemon's NodeState", 300)
        c = d.syncer.classifier
        _wait(lambda: id(c.payload) in d._payload_attached, "the payload daemon's attach", 60)
        fb = st["daemon_fb"]
        stage_dir = os.path.join(d.state_dir, "staging")
        os.makedirs(stage_dir, exist_ok=True)
        gen0 = None
        for k in range(2):
            daemon.write_frames_file_v2(os.path.join(stage_dir, f"{k}.frames"), fb)
            torch.cuda.synchronize()
            for kern in kernels:
                kern.launches = 0
            t = time.perf_counter()
            os.replace(os.path.join(stage_dir, f"{k}.frames"),
                       os.path.join(d.ingest_dir, f"{k}.frames"))
            _wait(lambda: os.path.exists(os.path.join(d.out_dir, f"{k}.frames.verdicts.json")),
                  "the payload daemon's pass", 600, 0.002)
            dt = time.perf_counter() - t
            daemon_launches[f"payload {k}"] = {x.name: x.launches for x in kernels if x.launches}
            got = open(os.path.join(d.out_dir, f"{k}.frames.verdicts.bin"), "rb").read()
            if got != st["daemon_stateless"]:
                raise SystemExit(f"payload daemon: pass {k}'s verdict file differs from the "
                                 f"stateless daemon's")
            passes.append({"s": dt, "graphs": c.resident.graphs(),
                           "allocs": c.resident_counters()["resident_allocs_total"]})
            if k == 0:
                gen0 = int(c.flow._gens_host[0])
                ppay.save_patterns(ppay.signature_patterns(np.random.default_rng(1), 32, 64),
                                   os.path.join(d.patterns_dir, "p1.npz"), version="dropped")
                _wait(lambda: c.payload_counters()["payload_pattern_swaps_total"] == 1,
                      "the payload daemon's pattern swap", 60)
        gen1 = int(c.flow._gens_host[0])
        if (gen1 != gen0 + 1 or os.listdir(d.patterns_dir)
                or (passes[1]["graphs"], passes[1]["allocs"]) != (passes[0]["graphs"],
                                                                  passes[0]["allocs"])):
            raise SystemExit(f"payload daemon: after the swap generation {gen0} -> {gen1}, "
                             f"patterns/ {os.listdir(d.patterns_dir)}, passes {passes}")
        pc = c.payload_counters()
        for key in pc:
            if _metric(d, key) != pc[key]:
                raise SystemExit(f"payload daemon: /metrics {key} {_metric(d, key)} is not the "
                                 f"classifier's {pc[key]}")
        log(f"{tag} payload daemon (--resident --payload default): 2 passes of {len(fb)} frames "
            f"in {passes[0]['s']:.3f} / {passes[1]['s']:.3f} s, launches {daemon_launches} "
            f"(frames carry no payload bytes: served on headers); verdict files equal to the "
            f"stateless daemon's; a set dropped into patterns/ between them swapped (generation "
            f"{gen0} -> {gen1}, graphs {passes[0]['graphs']} and allocs {passes[0]['allocs']} "
            f"unchanged by the second pass); payload_* on /metrics equal to the classifier's {pc}")
    finally:
        d.stop()
    shutil.rmtree(root, ignore_errors=True)

    main = timings[str(PAYLOAD_CHUNK)]
    return {
        "name": "payload_match", "route": "cuda",
        "source": "infw_torch/kernels/csrc/payload_match.cu",
        "replaces": "infw/kernels/acmatch.py:274",
        "launches": cell["shadow"]["launches"]["resident"].get("payload_match_resident", 0),
        "mismatches": 0, "max_abs_err": 0,
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "entries": {"classic": "payload_match", "resident": "payload_match_resident"},
        "checked_configurations": checked, "timings": timings, "ladder": ladder,
        "plan_ladder": plans["sizes"], "crossover_measured": plans["crossover"],
        "chain_floor": floor,
        "admission": adm, "admission_on_off": ratio, "cell": cell,
        "payload_daemon_launches": daemon_launches, "daemon_passes": passes,
    }


# the daemon's ingest ring (ROADMAP item 24c): records of RING_RECORD packets
# (7-word wire) of flow_trace_batch traffic over the flow phase's daemon
# table, SYN / ACK / FIN and a 2% share of RST|ACK lanes, with
# bench_payload's 64-byte payload prefixes at its 10% attack mix; a pass is
# RING_RECORDS records with one 4-word record of IPv4 lanes among them (a
# shape-class break), and a last record of RST_ROWS RST|ACK packets of
# established flows
RING_RECORD, RING_RECORDS, RING_K, RING_SEED, RST_ROWS = 4096, 32, 4, 7900, 4096
# the daemon's tick budget (and the ring's slot size) and its pipeline depth:
# 20 slots of 32768 packets, 8 records a tick
RING_TICK_PACKETS, RING_DEPTH = 8 * 4096, 8


def ring_traffic(tables, pats) -> tuple:
    """The ring phase's records: (one pass's records, the RST record), each
    record (wire, v4_only, flags, payload, lengths) in push order, and the
    pass's trace, payload and lengths for the producer."""
    from infw_torch import testing
    from infw_torch.constants import IPPROTO_TCP, TCP_ACK, TCP_RST

    rng = np.random.default_rng(RING_SEED)
    n = RING_RECORD * RING_RECORDS
    trace, _meta = testing.flow_trace_batch(rng, tables, n, 0.9, chunk_packets=RING_RECORD)
    flags = np.asarray(trace.tcp_flags).copy()
    flags[(flags == TCP_ACK) & (rng.random(n) < 0.02)] = TCP_RST | TCP_ACK
    trace.tcp_flags = flags
    pay, plen = payload_mix(np.random.default_rng(1500), n, pats, 64)

    def rec(idx, fl=None, p=None, pl=None):
        w, v4 = trace.pack_wire_subset(np.asarray(idx, np.int64))
        return (w, v4, flags[idx] if fl is None else fl, pay[idx] if p is None else p,
                plen[idx] if pl is None else pl)

    half = RING_RECORDS // 2
    recs = [rec(np.arange(i * RING_RECORD, (i + 1) * RING_RECORD)) for i in range(RING_RECORDS)]
    v4 = np.nonzero(np.asarray(trace.kind) == 1)[0][:RING_RECORD]
    brk = rec(v4)
    if brk[0].shape[1] != 4 or any(r[0].shape[1] != 7 for r in recs):
        raise SystemExit(f"ring: record widths {[r[0].shape for r in recs]} and {brk[0].shape}")
    recs.insert(half, brk)
    # the RST record: one packet of each of RST_ROWS established TCP flows
    wire7 = trace.pack_wire()
    tcp = np.nonzero((np.asarray(trace.proto) == IPPROTO_TCP) & (flags == TCP_ACK))[0]
    _u, first = np.unique(wire7[tcp], axis=0, return_index=True)
    pick = np.sort(tcp[first])[:RST_ROWS]
    rst = rec(pick, fl=np.full(len(pick), TCP_RST | TCP_ACK, np.int32),
              p=np.zeros((len(pick), 64), np.uint8), pl=np.zeros(len(pick), np.int32))
    return recs, rst, trace, pay, plen


def ring_producer(ring_path: str, trace, pay, plen, brk) -> tuple:
    """A producer thread on the port's loadgen (push_records): one pass, the
    first half of the records, the break record, the second half.  ->
    (thread, its result list)."""
    import threading

    from infw_torch.ring import IngestRing
    from infw_torch.tools import loadgen

    half = RING_RECORDS // 2 * RING_RECORD
    out: list = []

    def run():
        prod = IngestRing.attach(ring_path)
        try:
            out.append(loadgen.push_records(prod, trace.slice(0, half), RING_RECORD,
                                            pay[:half], plen[:half], timeout=300.0))
            w, v4, fl, p, pl = brk
            prod.push(w, v4_only=v4, tcp_flags=fl, payload=p, payload_len=pl, timeout=300.0)
            n = len(trace)
            out.append(loadgen.push_records(prod, trace.slice(half, n), RING_RECORD,
                                            pay[half:], plen[half:], timeout=300.0))
        except Exception as e:  # surfaced by the phase
            out.append(e)
        finally:
            prod.close()

    t = threading.Thread(target=run, name="ring-producer")
    t.start()
    return t, out


def ring_config(tag: str, name: str, pats, mode: str, resident: bool, recs, rst, trace, pay,
                plen) -> dict:
    """One daemon configuration of the ring phase (see ring_phase)."""
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from infw_torch import daemon
    from infw_torch.backend.cuda import TorchClassifier
    from infw_torch.constants import FLOW_FIN
    from infw_torch.flow import FlowConfig
    from infw_torch.kernels import all_kernels
    from infw_torch.ring import IngestRing

    st = FLOW_STASH
    kernels = all_kernels()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "ring-smoke", name)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    extra = {"resident": True, "superbatch_k": RING_K} if resident else {}
    d = daemon.Daemon(state_dir=os.path.join(root, "state"), node_name=DAEMON_NODE,
                      registry=st["daemon_registry"], metrics_port=0, health_port=0,
                      poll_period_s=0.1, file_poll_interval_s=0.002,
                      pipeline_depth=RING_DEPTH, max_tick_packets=RING_TICK_PACKETS,
                      flow_table=FlowConfig.make(entries=FLOW_SLAB), payload=pats,
                      payload_mode=mode, trace=True, ring=os.path.join(root, "ingest.ring"),
                      backend="cuda" if DEV == "cuda" else "cpu", **extra)
    ring = d.ingest_ring
    card = DEV == "cuda"
    if card and ring.pinned == resident:
        raise SystemExit(f"ring {name}: staging {ring.pinned} (pinned staging is the "
                         f"multi-dispatch daemon's, the resident pool stages its own)")
    # the daemon's order of pops (each record's dispatch follows its pop at
    # once) and drains, and each record's verdicts (PendingClassify caches
    # them): the multi-dispatch plan inserts a record's misses when it
    # materializes, so the flow tier's counters depend on that order
    served, pinned_views, events = {}, [], []
    drain, pop = d._ring_drain_one, ring.pop

    def drain_one():
        chunk, pending, _trace = d._ring_inflight[0]
        if card and not resident and len(pinned_views) < 4:
            pinned_views.append(all(torch.from_numpy(a).is_pinned() for a in (
                chunk.wire, chunk.tcp_flags, chunk.payload, chunk.payload_len)))
        # read back and noted before drain() releases the slot, which the
        # main thread waits on
        served[chunk.seq] = pending.result()
        events.append(("drain", chunk.seq))
        drain()

    def pop_logged(timeout=0.0):
        chunk = pop(timeout)
        if chunk is not None:
            events.append(("pop", chunk.seq))
        return chunk

    d._ring_drain_one, ring.pop = drain_one, pop_logged
    total = 3 * len(recs) + 1

    def wait_drained(what: str, n: int) -> None:
        _wait(lambda: ring.tail >= n, f"the ring {name} daemon's {what}", 300, 0.001)

    out = {"records": total}
    try:
        d.start()
        for k in kernels:
            k.launches = 0
        # pass 1: records wait in the ring until the NodeState lands, so the
        # first ticks find it full (superbatches of K in the resident daemon)
        thread, res = ring_producer(ring.path, trace, pay, plen, recs[len(recs) // 2])
        _wait(lambda: len(ring) >= min(ring.slots, len(recs)) or not thread.is_alive(),
              f"the ring {name} prefill", 120)
        p = os.path.join(d.nodestates_dir, f"{DAEMON_NODE}.json")
        with open(p + ".tmp", "w") as f:
            json.dump(st["daemon_doc"], f)
        os.replace(p + ".tmp", p)
        wait_drained("pass 1", len(recs))
        thread.join()
        c = d.syncer.classifier
        # pass 2, timed: the producer writes while the daemon serves (a
        # superbatch of another size than pass 1's captures its graph here)
        graphs0 = c.resident.graphs() if resident else 0
        spans0 = d.tracer.histograms.values()
        t = time.perf_counter()
        thread, res2 = ring_producer(ring.path, trace, pay, plen, recs[len(recs) // 2])
        wait_drained("pass 2", 2 * len(recs))
        wall = time.perf_counter() - t
        thread.join()
        spans1 = d.tracer.histograms.values()
        split = {s: (spans1[s]["sum_us"] - spans0[s]["sum_us"]) / 1e3
                 for s in ("ingest", "h2d", "dispatch", "materialize", "drain")}
        errs = [r for r in res + res2 if isinstance(r, Exception)]
        if errs:
            raise SystemExit(f"ring {name}: the producer failed: {errs[0]!r}")
        npk = sum(len(r[0]) for r in recs)
        out.update(pass_s=wall, packets=npk, packets_per_s=npk / wall, stage_ms=split,
                   pass_captures=(c.resident.graphs() - graphs0) if resident else 0,
                   producer=res2[-1])
        # pass 3, profiled: the copies' kinds and the card's idle share
        disp0 = c.resident_counters().get("resident_dispatches_total", 0)
        with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card
                                                          else [])) as prof:
            if card:
                for _ in range(64):
                    torch.cuda._sleep(1000)  # takes the trace's first, dropped events
                torch.cuda.synchronize()
            t = time.perf_counter()
            thread, res3 = ring_producer(ring.path, trace, pay, plen, recs[len(recs) // 2])
            wait_drained("pass 3", 3 * len(recs))
            wall3 = time.perf_counter() - t
            thread.join()
            if card:
                torch.cuda.synchronize()
        errs = [r for r in res3 if isinstance(r, Exception)]
        if errs:
            raise SystemExit(f"ring {name}: the producer failed: {errs[0]!r}")
        _copy_ms, _over, names, busy_ms = copy_overlap(prof)
        pinned = names.get("Memcpy HtoD (Pinned -> Device)", 0)
        pageable = names.get("Memcpy HtoD (Pageable -> Device)", 0)
        disp3 = c.resident_counters().get("resident_dispatches_total", 0) - disp0
        out.update(profiled_pass_s=wall3, busy_ms=busy_ms,
                   idle_share=max(0.0, 1.0 - busy_ms / 1e3 / wall3), copies=names)
        # the RST record: each of its lanes that hits tears its flow down
        fc0 = c.flow_counters()
        w, v4, fl, p, pl = rst
        prod = IngestRing.attach(ring.path)
        prod.push(w, v4_only=v4, tcp_flags=fl, payload=p, payload_len=pl, timeout=60.0)
        prod.close()
        wait_drained("RST record", total)
        fc1 = c.flow_counters()
        launches = {k.name: k.launches for k in kernels if k.launches}
        cols = c.flow.flow_columns()
        fin_entries = int((cols["se"][:, 0] == FLOW_FIN).sum())
        out.update(launches=launches, flow=fc1, fin_entries=fin_entries,
                   rst_torn=fc0["flow_occupancy"] - fc1["flow_occupancy"],
                   payload=c.payload_counters(), ring=ring.counter_values())
        if resident:
            out["resident"] = c.resident_counters()
            # each graph's first run (before its capture) launches its steps
            warm = sum(max(key[4], 1) for key in c.resident._ctx.graphs)
            out["graphs"] = len(c.resident._ctx.graphs)
            if card and not all(g.pinned_in.is_pinned()
                                for g in c.resident._ctx.graphs.values()):
                raise SystemExit(f"ring {name}: a graph's input buffer is not pinned")
        # every slot released, /metrics' ring_* the ring's
        if not (ring.tail == ring.head == total and not d._ring_inflight
                and len(served) == total):
            raise SystemExit(f"ring {name}: tail {ring.tail}, head {ring.head}, "
                             f"{len(d._ring_inflight)} in flight, {len(served)} served of {total}")
        for key, v in ring.counter_values().items():
            if _metric(d, key) != v:
                raise SystemExit(f"ring {name}: /metrics {key} {_metric(d, key)} is not {v}")
        # the same records in the same order through the classic entry points
        ref = TorchClassifier(device=None if card else "cpu", payload=pats, payload_mode=mode,
                              flow_table=FlowConfig.make(entries=FLOW_SLAB))
        ref.load_tables(st["daemon_tables"])
        # (the multi-dispatch daemon's pops and drains replayed in its order;
        # a resident step inserts before the next step probes, so the
        # resident daemon's order is the records')
        order = recs * 3 + [rst]
        replay = events if not resident else [(e, seq) for seq in range(total)
                                               for e in ("pop", "drain")]
        pend = {}
        for ev, seq in replay:
            if ev == "pop":
                w, v4, fl, p, pl = order[seq]
                pend[seq] = ref.classify_async_packed(w, v4, tcp_flags=fl, payload=p,
                                                      payload_len=pl)
                continue
            o, g = pend.pop(seq).result(), served[seq]
            if not (np.array_equal(g.results, o.results) and np.array_equal(g.xdp, o.xdp)):
                raise SystemExit(f"ring {name}: record {seq}'s verdicts differ from the classic "
                                 f"entry's ({int((g.results != o.results).sum())} lanes)")
        if not np.array_equal(np.asarray(c.stats.snapshot()), np.asarray(ref.stats.snapshot())):
            raise SystemExit(f"ring {name}: statistics differ from the classic entry's")
        if c.payload_counters() != ref.payload_counters():
            raise SystemExit(f"ring {name}: payload counters {c.payload_counters()} are not the "
                             f"classic entry's {ref.payload_counters()}")
        # all but the idle loop's age sweeps, timed by the wall clock (which
        # aged nothing)
        rfc = ref.flow_counters()
        rfc["flow_age_sweeps_total"] = fc1["flow_age_sweeps_total"]
        if fc1 != rfc or fc1["flow_aged_total"]:
            raise SystemExit(f"ring {name}: flow counters {fc1} are not the classic entry's "
                             f"{rfc}")
        ref.close()
        # the flags reached K7 and K8; K11 launched as expected
        if (fc1["flow_promotes_total"] <= 0 or fin_entries <= 0 or out["rst_torn"] <= 0):
            raise SystemExit(f"ring {name}: SYN promotes {fc1['flow_promotes_total']}, FIN "
                             f"entries {fin_entries}, RST teardowns {out['rst_torn']}")
        if not card:
            k11 = None  # the plain versions count no launch
        elif resident:
            k11 = launches.get("payload_match_resident", 0)
            want = total + warm
            sb = out["resident"]["resident_superbatch_dispatches_total"]
            if k11 != want or sb <= 0 or launches.get("payload_match", 0):
                raise SystemExit(f"ring {name}: K11 resident launches {k11}, expected {want} "
                                 f"(one a step: {total} records, {warm} in the first runs of "
                                 f"{out['graphs']} graphs), superbatches {sb}, {launches}")
            if pinned < disp3:
                raise SystemExit(f"ring {name}: {pinned} pinned and {pageable} pageable copies "
                                 f"in the profiled pass of {disp3} dispatches")
        else:
            k11 = launches.get("payload_match", 0)
            if k11 != total:
                raise SystemExit(f"ring {name}: K11 launches {k11}, expected one a record "
                                 f"({total}); {launches}")
            if not all(pinned_views) or pinned < 3 * len(recs):
                raise SystemExit(f"ring {name}: popped views pinned {pinned_views}, {pinned} "
                                 f"pinned and {pageable} pageable copies in the profiled pass "
                                 f"of {len(recs)} records")
        out.update(pinned_copies=pinned, pageable_copies=pageable, k11=k11,
                   profiled_dispatches=disp3 if resident else len(recs))
        log(f"{tag} ring {name}: {len(recs)} records ({npk} packets, one 4-word) a pass in "
            f"{wall:.3f} s = {npk / wall / 1e6:.3f} M packets/s ({out['pass_captures']} graphs "
            f"captured in it; the producer writing "
            f"alongside: {out['producer']}); ring spans of the pass (ms, summed over records): "
            f"{ {k: round(v, 3) for k, v in split.items()} }; profiled pass {wall3:.3f} s, card "
            f"busy {busy_ms:.3f} ms = idle share {out['idle_share']:.4f}; copies {names}; "
            f"launches over {total} records {launches}; flow {fc1}; FIN entries {fin_entries}, "
            f"RST teardowns {out['rst_torn']}; payload {out['payload']}"
            + (f"; resident {out['resident']}, graphs {out['graphs']}" if resident else ""))
    finally:
        d.stop()
    shutil.rmtree(root, ignore_errors=True)
    return out


def ring_phase(tag: str) -> dict:
    """The daemon's ingest ring (ROADMAP item 24c) on the card: a producer
    thread (infw_torch.tools.loadgen.push_records) writes the records of
    ring_traffic into the daemon's ring, which serves them:

    (a) --ring --flow-table --payload (bench_payload's 64 patterns x 64 B,
        seed 11, shadow) on the multi-dispatch plan, the ring's pinned
        staging on;
    (b) --ring --resident --superbatch-k 4 --payload (the same set,
        enforce), the resident pool's pinned input.

    Each: pass 1 fills the ring before the NodeState lands; pass 2 is timed
    (packets/s, the ring spans); pass 3 runs under the profiler (the
    copies' kinds, the card's busy time); then the RST record.  Fatal: the
    verdicts of every record, the statistics, the payload and flow
    counters equal to the same records through the classic entry point
    (classify_async_packed) in the same order; K11 launched once a record
    (a) or once a step, superbatch or single, plus the first runs of the
    graphs captured (b); SYN promotes, FIN entries and RST teardowns above
    0; every slot released, ring_* on /metrics equal to the ring's; the
    popped views pinned and three pinned copies a record in the profiled
    pass (a), the graphs' inputs pinned (b)."""
    from infw_torch import payload as ppay

    pats = ppay.signature_patterns(np.random.default_rng(11), 64, plen=64)
    recs, rst, trace, pay, plen = ring_traffic(FLOW_STASH["daemon_tables"], pats)
    out = {"register": ring_register_probe(tag)} if DEV == "cuda" else {}
    for name, mode, resident in (("a", "shadow", False), ("b", "enforce", True)):
        out[name] = ring_config(tag, name, pats, mode, resident, recs, rst, trace, pay, plen)
    log(f"{tag} ring (b) against (a): {out['b']['packets_per_s'] / 1e6:.3f} against "
        f"{out['a']['packets_per_s'] / 1e6:.3f} M packets/s, idle share "
        f"{out['b']['idle_share']:.4f} against {out['a']['idle_share']:.4f}")
    return out


def ring_register_probe(tag: str) -> int:
    """Whether CUDA registers a ring file's mapping under build/ as
    page-locked memory (cudaHostRegister), the JAX ring's zero-copy design;
    the daemon stages each record into pinned buffers instead, whatever
    this answers.  Returns the CUDA error code (0: registered)."""
    import shutil
    import threading

    import torch

    from infw_torch.ring import IngestRing

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "build", "ring-register")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ring = IngestRing.create(os.path.join(root, "r.ring"), slots=8, slot_packets=4096)
    buf = np.frombuffer(ring._mm, np.uint8)
    ptr, size = int(buf.ctypes.data), int(buf.nbytes)
    del buf
    cudart, result = torch.cuda.cudart(), []

    def register():
        rc = int(cudart.cudaHostRegister(ptr, size, 0))
        if rc == 0:
            cudart.cudaHostUnregister(ptr)
        result.append(rc)

    # on a thread of its own: the runtime keeps a refused call's error as
    # that thread's last error, which the next launch check on the same
    # thread would raise
    probe = threading.Thread(target=register, name="ring-register")
    probe.start()
    probe.join()
    rc = result[0]
    ring.close()
    shutil.rmtree(root, ignore_errors=True)
    fs = subprocess.run(["stat", "-f", "-c", "%T", here], capture_output=True,
                        text=True).stdout.strip()
    log(f"{tag} ring: cudaHostRegister of a {size}-byte ring mapping on this checkout's "
        f"filesystem ({fs}) returns CUDA error {rc} (0 registered, 1 cudaErrorInvalidValue)")
    return rc


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description="Chip smoke test of infw_torch on one card.")
    parser.add_argument("--parent", metavar="DIR",
                        help="another tree of this repository whose K2, K3, K3b, K5, K6, K7, "
                             "K8, K9, K10 and K11 are timed beside this tree's")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from infw_torch import compiler, oracle, spec, testing, validate
    from infw_torch.backend.cuda import TorchClassifier
    from infw_torch.interfaces import Interface, InterfaceRegistry
    from infw_torch.kernels import all_kernels, dense, torchpath
    from infw_torch.packets import narrow_wire

    # 1. device
    t_start = time.perf_counter()
    # a run still going near its limit prints where each thread stands
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=False)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    log(f"device: {kind} (count {count}), torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(card)
    tag = f"[{card}]"

    # 2. build: one nvcc per source, all at once
    t0 = time.perf_counter()
    kernels = all_kernels()
    if opts.parent:
        PARENT_KERNELS.update(parent_kernels(opts.parent))
    # one build per library: two entry points of one source share it
    own = list({k.library_path(): k for k in kernels}.values())
    builds = own + list({k.library_path(): k for k in PARENT_KERNELS.values()}.values())
    def build(k):
        k.build()
        return time.perf_counter()

    with ThreadPoolExecutor(len(builds)) as pool:
        done = [pool.submit(build, k) for k in builds]
        # the ctrie phase's table A takes about a minute of host work:
        # it is built meanwhile
        table_a = ctrie_table_a()
        host_s = time.perf_counter() - t0
        build_s = max(f.result() for f in done) - t0
    log(f"build: {len(kernels)} kernel entry points from {len(own)} sources"
        + (f" and --parent's {len(builds) - len(own)}" if opts.parent else "")
        + f" in {build_s:.2f} s; the ctrie phase's table A built on the host meanwhile in "
        f"{host_s:.2f} s")
    for k in own:
        for line in k.build_log().splitlines():
            if any(s in line for s in ("registers", "spill", "smem", "Compiling entry")):
                log(f"  ptxas {k.source.stem}: {line.strip()}")
    imma = sass_count(dense.KERNEL, ("IMMA", "HGMMA"))
    log(f"K1 on the tensor cores: {imma} IMMA/HGMMA instructions in the SASS of "
        f"{dense.KERNEL.library_path().name} (cuobjdump -sass)")
    if imma == 0:
        raise SystemExit("K1's SASS holds no IMMA or HGMMA instruction")

    # 3. K1 against its plain version
    rng = np.random.default_rng(20)
    head = tables_with_entries(
        testing, compiler, rng, HEADLINE_ENTRIES, HEADLINE_WIDTH, (2, 3, 4)
    )
    head_batch = testing.random_batch_fast(rng, head, HEADLINE_PACKETS)
    dt, fields, words, err_head = compare_k1(dense, torchpath, head, head_batch, "headline")
    limit = tables_with_entries(testing, compiler, rng, LIMIT_ENTRIES, LIMIT_WIDTH, (2, 3))
    limit_batch = testing.random_batch_fast(rng, limit, LIMIT_PACKETS)
    _, _, _, err_limit = compare_k1(dense, torchpath, limit, limit_batch, "dense limit")

    # 4. the main path, through the entry points a user calls
    registry = InterfaceRegistry()
    for name, index in (("eth0", 2), ("eth1", 3), ("eth2", 4)):
        registry.add(Interface(name=name, index=index))
    infs = [spec.IngressNodeFirewall.from_dict(d) for d in make_crs(np.random.default_rng(7))]
    for i, inf in enumerate(infs):
        errs = validate.validate_ingress_node_firewall(inf, infs[:i])
        if errs:
            raise SystemExit(f"validation rejected {inf.metadata.name}: {errs[:3]}")
    bad = spec.IngressNodeFirewall.from_dict({
        "metadata": {"name": "blocks-ssh"},
        "spec": {"interfaces": ["eth0"], "ingress": [{
            "sourceCIDRs": ["192.0.2.0/24"],
            "rules": [{"order": 1, "protocolConfig": {"protocol": "TCP", "tcp": {"ports": 22}},
                       "action": "Deny"}]}]},
    })
    if not validate.validate_ingress_node_firewall(bad):
        raise SystemExit("validation admitted a Deny rule over the SSH failsafe port")
    iface_rules = {
        name: [ing for inf in infs if name in inf.spec.interfaces for ing in inf.spec.ingress]
        for name in ("eth0", "eth1", "eth2")
    }
    tables = compiler.compile_tables(iface_rules, registry)
    log(f"main path tables: {tables.num_entries} entries x {tables.rule_width} rule slots")
    clf = TorchClassifier()
    clf.load_tables(tables)
    log(f"main path K1 layout: {k1_groups(dense, clf._active.dev)}")
    batch = testing.random_batch_fast(np.random.default_rng(8), tables, HEADLINE_PACKETS)

    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    out = clf.classify(batch)
    main_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    log(f"dense main path: classify({len(batch)}) in {main_s:.3f} s (first call), "
        f"launches {launches}")
    if launches["dense_classify"] <= 0:
        raise SystemExit("kernel dense_classify was not launched on the dense main path")
    if out.xdp.shape != (len(batch),):
        raise SystemExit("dense main path: verdicts have the wrong shape")
    check_recount(batch, out.results, out.stats_delta, "dense main path")
    hist = np.bincount(out.xdp, minlength=3)
    log(f"main path verdicts: drop={hist[1]} pass={hist[2]} "
        f"rule hits={int((out.results != 0).sum())}")
    check_oracle(clf, lambda sub: oracle.classify(tables, sub), {
        "mixed": batch.slice(0, ORACLE_PACKETS),  # 6-word narrow wire
        "v4-only": batch.take(np.nonzero(batch.kind != 2)[0][:ORACLE_PACKETS]),  # 3-word
    }, "dense main path")
    head_sub = batch.slice(0, ORACLE_PACKETS)
    if not (np.array_equal(out.results[:ORACLE_PACKETS], oracle.classify(tables, head_sub).results)):
        raise SystemExit("the 2^20-packet run disagrees with the oracle on its first packets")

    # 5. timings at the headline shape
    B, Tp, R = fields.shape[0], dt.entries.shape[0], dt.rules.shape[1]
    k1_ms, lpm_ms = k1_split(tag, dense, fields, words, dt)
    k1_dev = k1_device(tag, dense, fields, words, dt)
    layout_ms = k1_layout_times(tag, dense, fields, words, dt, lpm_ms)
    plain_ms = cuda_ms(lambda: dense.dense_classify_plain(fields, words, dt), reps=3, warmup=1)
    bits = torch.randint(0, 2, (B, 160), dtype=torch.int8, device="cuda")
    mdt = torch.randint(-1, 2, (Tp, 160), dtype=torch.int8, device="cuda").t()  # column-major
    intmm_ms = cuda_ms(lambda: torch._int_mm(bits, mdt), reps=20)
    head_clf = TorchClassifier()
    head_clf.load_tables(head)
    head_clf.classify(head_batch)
    e2e_s = median_s(lambda: head_clf.classify(head_batch))
    # the same classify, stage by stage on the host clock
    stages = {}
    stage = lambda name, fn: timed_stage(stages, name, fn)

    wire_np = stage("wire pack", lambda: narrow_wire(head_batch.pack_wire()))
    wire_dev = stage("host-to-device copy",
                     lambda: torch.from_numpy(wire_np.view(np.int32)).to("cuda"))
    fused = stage("device pass", lambda: dense.classify_dense_wire_fused(dt, wire_dev))
    host = stage("device-to-host read", lambda: fused.cpu().numpy())

    def host_finalize():
        res16, stats = torchpath.split_wire_outputs(host, B)
        torchpath.merge_stats_host(stats)
        return torchpath.host_finalize_wire(res16, head_batch.kind)

    stage("host finalize", host_finalize)
    fused_ms = cuda_ms(lambda: dense.classify_dense_wire_fused(dt, wire_dev), reps=10)

    # The function's work covers the table's T real entries; padding rows
    # (mask_len -1) never match and are not counted.
    T = head.num_entries
    bytes_moved = B * (8 + 4 + 2) * 4 + T * dt.entries.shape[1] * 4 + T * R * 2 * 4
    ops = 2 * B * 160 * T  # the LPM's int8 mismatch product over the real entries
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3
    bound_by = "operations" if ops / INT8_OPS_PER_S > bytes_moved / HBM_BYTES_PER_S else "bytes"
    log(f"{tag} K1 dense_classify: {k1_ms:.4f} ms at B={B} T={T} Tp={Tp} R={R} "
        f"(bound {bound_ms:.4f} ms by {bound_by}; {B / k1_ms / 1e3:.1f} M packets/s)")
    log(f"{tag} K1 plain version: {plain_ms:.4f} ms")
    log(f"{tag} torch._int_mm stage-1 yardstick (B x 160 x Tp int8, LPM product only): "
        f"{intmm_ms:.4f} ms")
    log(f"{tag} device pass (unpack + K1 + finalize + stats + fuse): {fused_ms:.4f} ms")
    log(f"{tag} end-to-end classify: {e2e_s * 1e3:.2f} ms per {B} packets (median of 5) = "
        f"{B / e2e_s / 1e6:.3f} M packets/s")
    log(f"{tag} stages of one classify (host clock, ms): "
        + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in stages.items()))

    k1 = {
        "name": "dense_classify",
        "route": "cuda",
        "source": "infw_torch/kernels/csrc/dense_classify.cu",
        "replaces": "infw/kernels/pallas_dense.py:183",
        "launches": launches["dense_classify"],
        "mismatches": 0,
        "max_abs_err": max(err_head, err_limit),
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "int_mm_stage1_ms": intmm_ms,
        "lpm_only_ms": lpm_ms,
        "device_ms": k1_dev,
        "lpm_by_grouping_ms": layout_ms,
        "imma_instructions": imma,
    }

    log_phase(f"phase dense: {time.perf_counter() - t_start:.1f} s since the start")
    # 6. the trie path
    t_phase = time.perf_counter()
    k2, trie_tables, trie_batch = trie_phase(tag)
    log_phase(f"phase trie: {time.perf_counter() - t_phase:.1f} s; "
              f"{time.perf_counter() - t_start:.1f} s since the start")

    # 7. the ctrie path, then both walks on the depth-adversarial batches
    t_phase = time.perf_counter()
    k3, ctrie_tables, ctrie_batch, hashed = ctrie_phase(tag, trie_tables, trie_batch, table_a)
    del table_a
    log_phase(f"phase ctrie: {time.perf_counter() - t_phase:.1f} s; "
              f"{time.perf_counter() - t_start:.1f} s since the start")
    t_phase = time.perf_counter()
    k2["ms_depth_adversarial"], k3["two_column"]["ms_depth_adversarial"] = depth_phase(tag)
    log_phase(f"phase depth-adversarial: {time.perf_counter() - t_phase:.1f} s; "
              f"{time.perf_counter() - t_start:.1f} s since the start")

    # 8. the wire codecs on both paths' IPv4-compact chunks
    t_phase = time.perf_counter()
    k4 = codec_phase(tag, [
        ("trie", f"100K trie table, {TRIE_PACKETS}-packet batch", trie_tables, trie_batch,
         lambda sub: oracle.classify(trie_tables, sub)),
        ("ctrie", f"10M table A, {CTRIE_PACKETS}-packet batch", ctrie_tables, ctrie_batch,
         hashed.classify),
    ])

    log_phase(f"phase codecs: {time.perf_counter() - t_phase:.1f} s; "
              f"{time.perf_counter() - t_start:.1f} s since the start")
    del trie_tables, trie_batch, ctrie_tables, ctrie_batch, hashed

    # 9. the multi-tenant arena, the daemon's tenants, the clone-then-patch,
    # the dense-family arena (K6) and the overlay side-pool
    t_phase = time.perf_counter()
    k3b = arena_phase(tag)
    log_phase(f"phase arena: {time.perf_counter() - t_phase:.1f} s; "
              f"{time.perf_counter() - t_start:.1f} s since the start")
    t_phase = time.perf_counter()
    tenants = tenant_phase(tag)
    k3b["tenant_launches"] = tenants["launches"]
    log_phase(f"phase tenants: {time.perf_counter() - t_phase:.1f} s; "
              f"{time.perf_counter() - t_start:.1f} s since the start")
    t_phase = time.perf_counter()
    clone_phase(tag)
    log_phase(f"phase clone-then-patch: {time.perf_counter() - t_phase:.1f} s; "
              f"{time.perf_counter() - t_start:.1f} s since the start")
    t_phase = time.perf_counter()
    k6 = dense_arena_phase(tag)
    log_phase(f"phase dense arena: {time.perf_counter() - t_phase:.1f} s; "
              f"{time.perf_counter() - t_start:.1f} s since the start")
    t_phase = time.perf_counter()
    ov_launches = overlay_phase(tag, k6)
    k3b["two_column"]["overlay_launches"] = ov_launches["arena_ctrie_walk"]
    log_phase(f"phase overlay: {time.perf_counter() - t_phase:.1f} s; "
              f"{time.perf_counter() - t_start:.1f} s since the start")

    # 10. incremental patches and the overlay at the churn tier
    t_phase = time.perf_counter()
    churn_phase(tag)
    log_phase(f"phase churn: {time.perf_counter() - t_phase:.1f} s; "
              f"{time.perf_counter() - t_start:.1f} s since the start")

    # 11. the gather microbenchmark's kernel and tool
    t_phase = time.perf_counter()
    k5 = gather_phase(tag)
    log_phase(f"phase gather: {time.perf_counter() - t_phase:.1f} s; "
              f"{time.perf_counter() - t_start:.1f} s since the start")

    # 11b. the flow tier: the ladder, K7 and K8, the storm, the dense arena
    # and the daemon with a flow table
    t_phase = time.perf_counter()
    k7, k8 = flow_phase(tag)
    log_phase(f"phase flow: {time.perf_counter() - t_phase:.1f} s; "
              f"{time.perf_counter() - t_start:.1f} s since the start")

    # 11c. the resident step and the superbatch: bench_resident's shape, the
    # flow ladder's, K = 4, the warmed steady state and the daemon
    t_phase = time.perf_counter()
    resident_phase(tag, k7, k8)
    log_phase(f"phase resident: {time.perf_counter() - t_phase:.1f} s; "
              f"{time.perf_counter() - t_start:.1f} s since the start")

    # 11d. the telemetry plane: K9 against its plain version, bench_telemetry's
    # cell, K9's times, the daemon with --resident --telemetry --trace
    t_phase = time.perf_counter()
    k9 = telemetry_phase(tag)
    log_phase(f"phase telemetry: {time.perf_counter() - t_phase:.1f} s; "
              f"{time.perf_counter() - t_start:.1f} s since the start")

    # 11e. the anomaly-scoring tier: K10 against its plain version,
    # bench_mlscore's cell, K10's times, the daemon with --resident --mlscore
    t_phase = time.perf_counter()
    k10 = mlscore_phase(tag)
    log_phase(f"phase mlscore: {time.perf_counter() - t_phase:.1f} s; "
              f"{time.perf_counter() - t_start:.1f} s since the start")

    # 11f. the payload tier: K11 against its plain version, bench_payload's
    # cell, K11's times, the daemon with --resident --payload default
    t_phase = time.perf_counter()
    k11 = payload_phase(tag)
    log_phase(f"phase payload: {time.perf_counter() - t_phase:.1f} s; "
              f"{time.perf_counter() - t_start:.1f} s since the start")

    # 11g. the daemon's ingest ring: a producer thread, the multi-dispatch
    # daemon and the resident superbatch daemon against the classic entry
    t_phase = time.perf_counter()
    ring = ring_phase(tag)
    FLOW_STASH.clear()
    for k, names in ((k7, ("flow_probe", "flow_probe_resident")),
                     (k8, ("flow_insert", "flow_insert_resident")),
                     (k11, ("payload_match", "payload_match_resident"))):
        k["ring_daemon_launches"] = {cfg: {n: ring[cfg]["launches"].get(n, 0) for n in names}
                                     for cfg in ("a", "b")}
    log_phase(f"phase daemon ring: {time.perf_counter() - t_phase:.1f} s; "
              f"{time.perf_counter() - t_start:.1f} s since the start")

    # 12. the daemon: the headline CRs' ingress blocks as one NodeState,
    # then bench config 5a's replay, through infw_torch.daemon
    crs = make_crs(np.random.default_rng(7))
    t_phase = time.perf_counter()
    daemon_launches = daemon_phase(tag, {
        name: [ing for cr in crs if name in cr["spec"]["interfaces"] for ing in cr["spec"]["ingress"]]
        for name in DAEMON_IFACES
    })
    log_phase(f"phase daemon: {time.perf_counter() - t_phase:.1f} s; script "
        f"{time.perf_counter() - t_start:.1f} s so far")
    # each kernel's launches in each daemon pass, the two-column walks
    # under their own entries; a launch no entry names fails the run
    entries = [k1, k2, k3, k4, k3b, k5, k6, k7, k8, k9, k10, k11, k3["two_column"],
               k3b["two_column"], k6["two_column"]]
    for k in entries:
        k["daemon_launches"] = {p: c.get(k["name"], 0) for p, c in daemon_launches.items()}
    unlisted = {n for c in daemon_launches.values() for n in c} - {k["name"] for k in entries}
    if unlisted:
        raise SystemExit(f"daemon: kernels {sorted(unlisted)} launched but not on the kernels line")

    faulthandler.cancel_dump_traceback_later()
    # 13. the kernels line, then the device line last
    print(json.dumps({"kernels": [k1, k2, k3, k4, k3b, k5, k6, k7, k8, k9, k10, k11]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        stop_children()
