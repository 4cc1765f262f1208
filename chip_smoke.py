#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (infw_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's dense classify path on the card and fails (non-zero
exit, no result line) on any error:

1. device: the card's name and power limit (nvidia-smi);
2. build: every hand-written kernel from its source with nvcc; prints
   ptxas register / shared-memory / spill lines;
3. kernel K1 against its plain PyTorch version on the card, exact
   (result, tidx) equality, at the headline shape (1000 entries x 100
   rules on ifindexes 2, 3, 4, 2^20 packets) and at the dense limit
   (4096 entries x 16 rules, 2^18 packets);
4. the main path: IngressNodeFirewall CR dicts -> validate ->
   compile_tables -> TorchClassifier() -> classify on 2^20 packets, with
   launch counts zeroed just before and read just after; results, XDP
   verdicts and statistics checked bit for bit against the scalar oracle
   on 4096-packet subsets;
5. timings with CUDA events (K1, its plain version, torch._int_mm of the
   LPM's int8 mismatch product as a stage-1 yardstick the port never calls)
   and end-to-end classify packets/s on the host clock;
6. one JSON ``kernels`` line, then the device JSON as the last line.

Imports nothing of JAX or of the JAX package ``infw``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

HEADLINE_ENTRIES, HEADLINE_WIDTH, HEADLINE_PACKETS = 1000, 100, 1 << 20
LIMIT_ENTRIES, LIMIT_WIDTH, LIMIT_PACKETS = 4096, 16, 1 << 18
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
    fields, words = dense.packet_fields(torchpath.device_batch(batch, "cuda"))
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

    # 2. build
    t0 = time.perf_counter()
    kernels = all_kernels()
    for k in kernels:
        k.build()
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
    log(f"main path: classify({len(batch)}) in {main_s:.3f} s (first call), launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise SystemExit(f"kernel {name} was not launched on the main path")
    if out.results.shape != (len(batch),) or out.xdp.shape != (len(batch),):
        raise SystemExit("main path output has the wrong shape")
    if out.stats_delta.shape != (1024, 4):
        raise SystemExit("main path stats have the wrong shape")
    # full-batch statistics against a host recount from the verdicts
    res = out.results.astype(np.int64)
    act, rid = res & 0xFF, (res >> 8) & 0xFFFFFF
    is_ip = (batch.kind == 1) | (batch.kind == 2)
    recount = np.zeros((1025, 4), np.int64)
    for col, a in ((0, 2), (2, 1)):
        sel = (act == a) & is_ip
        sid = np.where(rid < 1024, rid, 1024)[sel]
        np.add.at(recount[:, col], sid, 1)
        np.add.at(recount[:, col + 1], sid, batch.pkt_len[sel].astype(np.int64))
    if not np.array_equal(recount[:1024], out.stats_delta):
        raise SystemExit("main path statistics disagree with the verdicts")
    hist = np.bincount(out.xdp, minlength=3)
    log(f"main path verdicts: drop={hist[1]} pass={hist[2]} "
        f"rule hits={int((out.results != 0).sum())}")
    subsets = {
        "mixed": batch.slice(0, ORACLE_PACKETS),  # 6-word narrow wire
        "v4-only": batch.take(np.nonzero(batch.kind != 2)[0][:ORACLE_PACKETS]),  # 3-word
    }
    for label, sub in subsets.items():
        got = clf.classify(sub, apply_stats=False)
        ref = oracle.classify(tables, sub)
        ok = (
            np.array_equal(got.results, ref.results)
            and np.array_equal(got.xdp, ref.xdp)
            and testing.stats_dict_from_array(got.stats_delta) == ref.stats
        )
        log(f"main path vs oracle [{label}, {len(sub)} packets]: "
            f"{'equal' if ok else 'DIFFERENT'}")
        if not ok:
            raise SystemExit(f"main path disagrees with the oracle on {label}")
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
    e2e = []
    for _ in range(5):
        t0 = time.perf_counter()
        head_clf.classify(head_batch)
        torch.cuda.synchronize()
        e2e.append(time.perf_counter() - t0)
    e2e_s = float(np.median(e2e))
    # the same classify, stage by stage on the host clock
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return r

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

    # 6. the kernels line, then the device line last
    print(json.dumps({"kernels": [{
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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
