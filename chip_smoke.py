#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (infw_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's dense and trie classify paths on the card and fails
(non-zero exit, no result line) on any error:

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
7. one JSON ``kernels`` line, then the device JSON as the last line.

Imports nothing of JAX or of the JAX package ``infw``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HEADLINE_ENTRIES, HEADLINE_WIDTH, HEADLINE_PACKETS = 1000, 100, 1 << 20
LIMIT_ENTRIES, LIMIT_WIDTH, LIMIT_PACKETS = 4096, 16, 1 << 18
# bench config 3 of the JAX package (bench.py bench_trie_100k)
TRIE_ENTRIES, TRIE_WIDTH, TRIE_PACKETS = 100_000, 8, 1 << 20
ORACLE_PACKETS = 4096
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


def check_oracle(clf, tables, subsets, label: str) -> None:
    """Each subset classified again on its own: results, XDP verdicts and
    statistics bit for bit against the scalar oracle."""
    from infw_torch import oracle, testing

    for name, sub in subsets.items():
        got = clf.classify(sub, apply_stats=False)
        ref = oracle.classify(tables, sub)
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


def trie_phase(tag: str) -> dict:
    """The trie path at bench config 3; returns K2's kernels-line entry."""
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
        f"(steered {steered_launches}, unsteered {launches['trie_walk'] - steered_launches})")
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
    check_oracle(clf, tables, {
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

    # Bound: each input read once (48 B of fields + words per packet, the
    # resident tables) and the (B, 2) output written once, over the HBM
    # rate.  The per-packet node rows mostly hit L2, so this is a floor.
    table_bytes = sum(t.numel() * 4 for t in tt[:6])
    bytes_moved = B * (48 + 8) + table_bytes
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    for nl in level_counts:
        log(f"{tag} K2 trie_walk [{nl} levels]: {k2_ms[nl]:.4f} ms at B={B} "
            f"({B / k2_ms[nl] / 1e3:.1f} M packets/s; {nl + 3} dependent loads per packet)")
    log(f"{tag} K2 bound: {bound_ms:.4f} ms by bytes ({bytes_moved / 1e6:.1f} MB: "
        f"{table_bytes / 1e6:.1f} MB of tables + {B * 56 / 1e6:.1f} MB in/out); "
        f"K2 at {n} levels is {k2_ms[n] / bound_ms:.1f}x its bound")
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
    check_oracle(clf, tables, {
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
    k2 = trie_phase(tag)

    # 7. the kernels line, then the device line last
    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
