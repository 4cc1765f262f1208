#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (infw_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's dense, trie and ctrie classify paths and its wire codecs
on the card and fails (non-zero exit, no result line) on any error:

1. device: the card's name and power limit (nvidia-smi);
2. build: every hand-written kernel from its source with nvcc, one nvcc
   per source, all started together; prints ptxas register /
   shared-memory / spill lines;
3. kernel K1 against its plain PyTorch version on the card, exact
   (result, tidx) equality, at the headline shape (1000 entries x 100
   rules on ifindexes 2, 3, 4, 2^20 packets) and at the dense limit
   (4096 entries x 16 rules, 2^18 packets);
4. the dense main path: IngressNodeFirewall CR dicts -> validate ->
   compile_tables -> TorchClassifier() -> classify on 2^20 packets, with
   launch counts zeroed just before and read just after; results, XDP
   verdicts and statistics checked bit for bit against the scalar oracle
   on 4096-packet subsets;
5. dense timings with CUDA events (K1, its plain version, torch._int_mm of
   the LPM's int8 mismatch product as a stage-1 yardstick the port never
   calls) and end-to-end classify packets/s on the host clock;
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
   steered and unsteered end-to-end times and the stage split;
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
   HashLpmOracle on 4096-packet subsets and the first packets of the run;
   K3 times on both tables, its bound, the plain version's time, the
   device pass, end to end and the stage split;
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
   values, its bound, the plain version and torch.cumsum;
9. one JSON ``kernels`` line, then the device JSON as the last line.

Imports nothing of JAX or of the JAX package ``infw``.
"""
from __future__ import annotations

import json
import os
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
# K4 against its plain version: sizes around its 1024-value block and the
# main path's 2^20 (timed there), each at byte offsets 0 and 1
K4_SIZES = (1, 1023, 1024, 1025, 1 << 20, (1 << 20) + 7)
# packets of each clustered chunk that takes a fixed-stride delta plan
FIXED_PACKETS = 8192
# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense int8 ops/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15


def log(msg: str) -> None:
    print(msg, flush=True)


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


def profiled_kernels(fn, reps: int):
    """torch.profiler over ``reps`` calls after a warm one: {kernel name:
    device microseconds per call}, from the CUDA events of the trace (kernels
    only, no copies or fills); empty when the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith(("Memcpy", "Memset")):
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / reps
    return out


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
        f"lpm-matched={matched}")
    if mism:
        raise SystemExit(f"K1 disagrees with its plain version at {label}")
    return dt, fields, words, err


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
    tt = walk.build_trie_tables(tables, "cuda")
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
            f"({B / k2_ms[nl] / 1e3:.1f} M packets/s; {nl + 3} dependent loads per packet)")
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
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }, tables, batch


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


def ctrie_phase(tag: str, trie_tables, trie_batch):
    """The ctrie path at the JAX package's 10M-entry tier (table A), with
    K3 also held against its plain version on the trie phase's 100K table
    (table B, deep /128 skip chains); returns K3's kernels-line entry,
    table A, its batch and its HashLpmOracle."""
    import torch

    from infw_torch import compiler, layout, oracle, testing
    from infw_torch.backend.cuda import TorchClassifier
    from infw_torch.kernels import all_kernels, cwalk, torchpath
    from infw_torch.packets import narrow_wire

    # table A: clean /24 + /48 columns, Allow-only, ifindexes 2 and 3
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
    ct = timed_stage(build, "upload", lambda: cwalk.build_ctrie_tables(tables, "cuda"))
    batch = testing.random_batch_fast(rng, tables, CTRIE_PACKETS)
    table_bytes = sum(t.numel() * t.element_size() for t in ct[:5])
    log(f"ctrie table A: {tables.num_entries} entries x {tables.rule_width} rule slots, "
        f"{tables.levels} trie levels; {nodes.shape[0]} node rows, "
        f"{int((nodes[:, 2] > 0).sum())} skip nodes, d_max {d_max}; device tables "
        f"{table_bytes / 1e6:.1f} MB (l0 {ct.l0.numel() * 4 / 1e6:.1f}, nodes "
        f"{ct.nodes.numel() * 4 / 1e6:.1f}, targets {ct.targets.numel() * 4 / 1e6:.1f}, "
        f"joined {ct.joined.numel() * 2 / 1e6:.1f})")
    log("ctrie table A build (host clock, s): "
        + ", ".join(f"{k} {v:.2f}" for k, v in build.items())
        + f"; compile split: arrays {arrays_s[0]:.2f}, "
        f"content map {build['compile'] - arrays_s[0]:.2f}")
    log(f"host memory after the build: peak RSS {peak_rss_gib():.2f} GiB of "
        f"{os.sysconf('SC_PAGE_SIZE') * os.sysconf('SC_PHYS_PAGES') / 2**30:.2f} GiB host RAM")

    # 1. K3 against its plain version, every packet of both tables
    fields, words = torchpath.packet_fields(torchpath.device_batch(batch, "cuda"))
    ct_b = cwalk.build_ctrie_tables(trie_tables, "cuda")
    fields_b, words_b = torchpath.packet_fields(torchpath.device_batch(trie_batch, "cuda"))
    log(f"ctrie table B: the trie phase's {trie_tables.num_entries} entries, "
        f"{ct_b.nodes.shape[0]} node rows, "
        f"{int((ct_b.nodes[:, 2] != 0).sum().item())} skip nodes, d_max {ct_b.d_max}")
    label_a = f"table A, {tables.num_entries} entries"
    label_b = f"table B, {trie_tables.num_entries} entries"
    err = max(compare_k3(cwalk, ct, fields, words, label_a),
              compare_k3(cwalk, ct_b, fields_b, words_b, label_b))

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
    if launches["ctrie_walk"] <= 0 or launches["trie_walk"] != 0:
        raise SystemExit("the ctrie main path must launch ctrie_walk and never trie_walk")
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
    hashed = timed_stage(loads, "HashLpmOracle", lambda: oracle.HashLpmOracle(tables))
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
    fused_ms = cuda_ms(lambda: cwalk.classify_ctrie_wire_fused(ct, wire_dev), reps=10)

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
        log(f"{tag} K3 ctrie_walk [{label}]: {ms:.4f} ms at B={n} ({n / ms / 1e3:.1f} M packets/s)")
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
    log(f"{tag} ctrie device pass (unpack + K3 + finalize + stats + fuse, table A): "
        f"{fused_ms:.4f} ms")
    log(f"{tag} ctrie end-to-end classify: {e2e_s * 1e3:.2f} ms per {B} packets (median of 5) = "
        f"{B / e2e_s / 1e6:.3f} M packets/s")
    log(f"{tag} ctrie stages of one classify (host clock, ms): "
        + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in stages.items()))
    return {
        "name": "ctrie_walk",
        "route": "cuda",
        "source": "infw_torch/kernels/csrc/ctrie_walk.cu",
        "replaces": "infw/kernels/pallas_walk.py:918",
        "launches": launches["ctrie_walk"],
        "mismatches": 0,
        "max_abs_err": err,
        "ms": k3_ms,
        "ms_table_b": k3_b_ms,
        "ms_first_4096_repeated": k3_hot_ms,
        "plain_ms": plain_ms,
        "plain_ms_table_b": plain_b_ms,
        "bound_ms": bound_ms,
        "bound_ms_table_b": bound_b_ms,
        "bound_by": "bytes",
        "library_ms": None,
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
        walker = "ctrie_walk" if path == "ctrie" else "trie_walk"
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
            if launches["wire_decode"] != want_k4 or launches[walker] != 1 or sum(
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
            dev = cwalk.build_ctrie_tables(tables, "cuda")
            narrow_pass = lambda wd: cwalk.classify_ctrie_wire_fused(dev, wd)
            wire8_pass = lambda wd, im: cwalk.classify_ctrie_wire8(dev, wd, im)
            delta_entry = wire_decode.classify_delta_ctrie
        else:
            dev = walk.build_trie_tables(tables, "cuda")
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
                    + "; ".join(f"{k[:60]} {v:.1f}" for k, v in top[:6]))
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

    # 5. K4 times at 2^20 values per width, its bound, the plain version and
    # torch.cumsum of the combined deltas (the prefix sum alone)
    rng = np.random.default_rng(46)
    n = K4_SIZES[-2]
    k4 = {}
    for w in (1, 2, 4):
        c = torch.from_numpy(rng.integers(0, 256, n * w + 1, dtype=np.uint8)).to("cuda")[1:]
        deltas = wire_decode._decode_fixed_deltas(c, n, w)
        device_us = profiled_kernels(lambda: wire_decode.decode_scan(c, n, w), reps=20)
        k4[w] = {
            "ms": cuda_ms(lambda: wire_decode.decode_scan(c, n, w), reps=50),
            "device_ms": sum(device_us.values()) / 1e3 if device_us else None,
            "plain_ms": cuda_ms(lambda: wire_decode.decode_scan_plain(c, n, w), reps=20),
            "library_ms": cuda_ms(lambda: torch.cumsum(deltas, 0), reps=50),
            "bound_ms": n * (w + 4) / HBM_BYTES_PER_S * 1e3,
        }
        log(f"{tag} K4 wire_decode [w={w}, n={n}]: {k4[w]['ms']:.4f} ms; bound "
            f"{k4[w]['bound_ms']:.4f} ms by bytes ({n * (w + 4)} bytes / 3.35 TB/s), "
            f"{k4[w]['ms'] / k4[w]['bound_ms']:.1f}x it; plain version {k4[w]['plain_ms']:.4f} ms; "
            f"torch.cumsum of the int64 deltas {k4[w]['library_ms']:.4f} ms; profiler device "
            f"time per call (us): " + (", ".join(f"{k[:40]} {v:.2f}" for k, v in device_us.items())
                                     or "not measured (no device events in the trace)"))
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
        "plain_ms": k4[4]["plain_ms"],
        "bound_ms": k4[4]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k4[4]["library_ms"],
        "by_width": {str(w): v for w, v in k4.items()},
        "codec_stages": timings,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from infw_torch import compiler, oracle, spec, testing, validate
    from infw_torch.backend.cuda import TorchClassifier
    from infw_torch.interfaces import Interface, InterfaceRegistry
    from infw_torch.kernels import all_kernels, dense, torchpath
    from infw_torch.packets import narrow_wire

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    log(f"device: {kind} (count {count}), torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(card)
    tag = f"[{card}]"

    # 2. build: one nvcc per source, all at once
    t0 = time.perf_counter()
    kernels = all_kernels()
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda k: k.build(), kernels))
    log(f"build: {len(kernels)} kernel(s) in {time.perf_counter() - t0:.2f} s")
    for k in kernels:
        for line in k.build_log().splitlines():
            if any(s in line for s in ("registers", "spill", "smem", "Compiling entry")):
                log(f"  ptxas {k.name}: {line.strip()}")

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
    k1_ms = cuda_ms(lambda: dense.dense_classify(fields, words, dt), reps=20)
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
    }

    # 6. the trie path
    k2, trie_tables, trie_batch = trie_phase(tag)

    # 7. the ctrie path
    k3, ctrie_tables, ctrie_batch, hashed = ctrie_phase(tag, trie_tables, trie_batch)

    # 8. the wire codecs on both paths' IPv4-compact chunks
    k4 = codec_phase(tag, [
        ("trie", f"100K trie table, {TRIE_PACKETS}-packet batch", trie_tables, trie_batch,
         lambda sub: oracle.classify(trie_tables, sub)),
        ("ctrie", f"10M table A, {CTRIE_PACKETS}-packet batch", ctrie_tables, ctrie_batch,
         hashed.classify),
    ])

    # 9. the kernels line, then the device line last
    print(json.dumps({"kernels": [k1, k2, k3, k4]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
