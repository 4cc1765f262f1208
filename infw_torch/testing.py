"""Seeded ruleset and packet generators (numpy), for tests and chip_smoke.

The same generators as the JAX package's ``infw/testing.py``, drawing the
same numbers from the same numpy Generator, so one seed gives the same
tables and batches on both sides.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import numpy as np

from .compiler import (
    CompiledTables,
    LpmKey,
    TableColumns,
    compile_tables_from_columns,
    compile_tables_from_content,
)
from .constants import (
    IPPROTO_ICMP,
    IPPROTO_ICMPV6,
    IPPROTO_SCTP,
    IPPROTO_TCP,
    IPPROTO_UDP,
    TCP_ACK,
    TCP_FIN,
    TCP_RST,
    TCP_SYN,
)
from .packets import PacketBatch

_PROTOS = [IPPROTO_TCP, IPPROTO_UDP, IPPROTO_SCTP, IPPROTO_ICMP, IPPROTO_ICMPV6, 0]


def random_rules(
    rng: np.random.Generator, width: int, max_rules: Optional[int] = None
) -> np.ndarray:
    """Random packed rule rows (width, 7) with the loader's invariants:
    index == order == ruleId, index 0 empty."""
    rows = np.zeros((width, 7), np.int32)
    n = rng.integers(0, max_rules if max_rules is not None else width - 1, endpoint=True)
    orders = rng.choice(np.arange(1, width), size=min(n, width - 1), replace=False)
    for order in orders:
        proto = _PROTOS[rng.integers(0, len(_PROTOS))]
        rows[order, 0] = order
        rows[order, 1] = proto
        if proto in (IPPROTO_TCP, IPPROTO_UDP, IPPROTO_SCTP):
            if rng.random() < 0.5:
                start = int(rng.integers(1, 65000))
                rows[order, 2] = start
                rows[order, 3] = int(rng.integers(start + 1, 65536))
            else:
                rows[order, 2] = int(rng.integers(1, 65536))
                rows[order, 3] = 0
        elif proto in (IPPROTO_ICMP, IPPROTO_ICMPV6):
            rows[order, 4] = int(rng.integers(0, 256))
            rows[order, 5] = int(rng.integers(0, 3))
        rows[order, 6] = int(rng.integers(1, 3))  # DENY or ALLOW
    return rows


def random_tables(
    rng: np.random.Generator,
    n_entries: int,
    ifindexes: Tuple[int, ...] = (2, 3),
    width: int = 16,
    v6_fraction: float = 0.3,
    overlap_fraction: float = 0.3,
) -> CompiledTables:
    """Random LPM content with deliberately overlapping prefixes (nested
    CIDRs of different lengths over shared bases) to stress longest-match
    tie-breaks."""
    content: Dict[LpmKey, np.ndarray] = {}
    bases: List[Tuple[bytes, bool]] = []
    while len(content) < n_entries:
        is_v6 = rng.random() < v6_fraction
        if bases and rng.random() < overlap_fraction:
            base, is_v6 = bases[rng.integers(0, len(bases))]
            data = bytearray(base)
            pos = rng.integers(1, 16)
            data[pos] = rng.integers(0, 256)
            data = bytes(data)
        else:
            if is_v6:
                data = bytes(rng.integers(0, 256, 16, dtype=np.uint8))
            else:
                data = bytes(rng.integers(0, 256, 4, dtype=np.uint8)) + bytes(12)
            bases.append((data, is_v6))
        if is_v6:
            mask_len = int(rng.choice([0, 8, 13, 24, 32, 48, 64, 96, 128]))
        else:
            mask_len = int(rng.choice([0, 1, 8, 13, 16, 24, 30, 31, 32]))
            data = data[:4] + bytes(12)
        ifindex = int(ifindexes[rng.integers(0, len(ifindexes))])
        key = LpmKey(prefix_len=mask_len + 32, ingress_ifindex=ifindex, ip_data=data)
        content[key] = random_rules(rng, width)
    return compile_tables_from_content(content, rule_width=width)


def random_rules_bulk(rng: np.random.Generator, n: int, width: int) -> np.ndarray:
    """(n, width, 7) packed rule rows, the vectorized random_rules: index ==
    order == ruleId, index 0 empty, mixed protocols, half port ranges and
    half single ports, DENY or ALLOW actions."""
    rows = np.zeros((n, width, 7), np.int32)
    if width < 2:
        return rows
    # per-entry fill probability in [0.3, 1.0] so table density varies
    fill_p = rng.uniform(0.3, 1.0, (n, 1))
    populated = rng.random((n, width)) < fill_p
    populated[:, 0] = False  # order 0 is reserved
    order = np.broadcast_to(np.arange(width, dtype=np.int32), (n, width))
    proto = np.asarray(_PROTOS)[rng.integers(0, len(_PROTOS), (n, width))]
    is_transport = (proto == IPPROTO_TCP) | (proto == IPPROTO_UDP) | (proto == IPPROTO_SCTP)
    is_icmp = (proto == IPPROTO_ICMP) | (proto == IPPROTO_ICMPV6)
    start = rng.integers(1, 65000, (n, width))
    use_range = rng.random((n, width)) < 0.5
    span = rng.integers(1, 500, (n, width))
    end = np.where(use_range, np.minimum(start + span, 65535), 0)
    rows[..., 0] = np.where(populated, order, 0)
    rows[..., 1] = np.where(populated, proto, 0)
    rows[..., 2] = np.where(populated & is_transport, start, 0)
    rows[..., 3] = np.where(populated & is_transport, end, 0)
    rows[..., 4] = np.where(populated & is_icmp, rng.integers(0, 256, (n, width)), 0)
    rows[..., 5] = np.where(populated & is_icmp, rng.integers(0, 3, (n, width)), 0)
    rows[..., 6] = np.where(populated, rng.integers(1, 3, (n, width)), 0)
    return rows


def random_tables_fast(
    rng: np.random.Generator,
    n_entries: int,
    ifindexes: Tuple[int, ...] = (2, 3),
    width: int = 16,
    v6_fraction: float = 0.3,
    group_size: int = 8,
) -> CompiledTables:
    """Vectorized large-table generator (the 100K-entry trie tier): entries
    cluster into groups sharing a base address with realistic prefix-length
    mixes (v4 peaked at /24, v6 at /48), so nested and sibling prefixes
    stress longest-match tie-breaks.  Exactly ``n_entries`` distinct masked
    identities."""
    return compile_tables_from_content(
        random_content_fast(rng, n_entries, ifindexes, width, v6_fraction, group_size),
        rule_width=width)


def random_content_fast(
    rng: np.random.Generator,
    n_entries: int,
    ifindexes: Tuple[int, ...] = (2, 3),
    width: int = 16,
    v6_fraction: float = 0.3,
    group_size: int = 8,
) -> Dict[LpmKey, np.ndarray]:
    """random_tables_fast's {LpmKey: (width, 7) rules} content, uncompiled
    (the same draws from ``rng``)."""
    content: Dict[LpmKey, np.ndarray] = {}
    seen = set()
    while len(content) < n_entries:
        n = int((n_entries - len(content)) * 1.4) + 64
        is_v6 = rng.random(n) < v6_fraction
        n_groups = max(1, n // group_size)
        bases = rng.integers(0, 256, (n_groups, 16), dtype=np.uint8)
        gid = rng.integers(0, n_groups, n)
        ip = bases[gid].copy()
        # sibling prefixes: perturb one tail byte on half the entries
        perturb = rng.random(n) < 0.5
        pos = rng.integers(1, 16, n)
        val = rng.integers(0, 256, n, dtype=np.uint8)
        ip[np.arange(n)[perturb], pos[perturb]] = val[perturb]

        v4_lens = np.array([0, 8, 12, 16, 20, 24, 24, 24, 28, 32])
        v6_lens = np.array([0, 32, 40, 48, 48, 48, 56, 64, 96, 128])
        mask_len = np.where(
            is_v6,
            v6_lens[rng.integers(0, len(v6_lens), n)],
            v4_lens[rng.integers(0, len(v4_lens), n)],
        ).astype(np.int64)
        ip[~is_v6, 4:] = 0
        ifindex = np.asarray(ifindexes)[rng.integers(0, len(ifindexes), n)]
        rules = random_rules_bulk(rng, n, width)

        ip_bytes = [bytes(row) for row in ip]
        for i in range(n):
            # exact masked-identity dedup, so the entry count is exact
            m = int(mask_len[i])
            nb, rem = m // 8, m % 8
            data = ip_bytes[i][:nb]
            if rem:
                data += bytes([ip_bytes[i][nb] & ((0xFF << (8 - rem)) & 0xFF)])
            ident = (int(ifindex[i]), m, data)
            if ident in seen:
                continue
            seen.add(ident)
            key = LpmKey(prefix_len=m + 32, ingress_ifindex=int(ifindex[i]), ip_data=ip_bytes[i])
            content[key] = rules[i]
            if len(content) >= n_entries:
                break
    return content


def clean_columns_fast(
    rng: np.random.Generator,
    n_entries: int,
    ifindexes: Tuple[int, ...] = (2, 3),
    width: int = 4,
    v6_fraction: float = 0.3,
) -> TableColumns:
    """Semantically clean columnar content at the 10M-entry scale, with no
    per-key Python: disjoint prefixes (distinct v4 /24s and v6 /48s under
    0x20, so no entry nests in another) carrying one distinct Allow rule
    each (TCP to one port, in rule slot 1)."""
    n_v6 = int(n_entries * v6_fraction)
    n_v4 = n_entries - n_v6
    if n_v4 > 1 << 24 or n_v6 > 1 << 40:
        raise ValueError("n_entries exceeds the disjoint-prefix space")
    v4_vals = rng.choice(1 << 24, size=n_v4, replace=False).astype(np.int64)
    # distinct 40-bit v6 prefixes: random draws deduped, topped up on collision
    v6_vals = np.unique(rng.integers(0, 1 << 40, n_v6 + 64, dtype=np.int64))
    while len(v6_vals) < n_v6:
        v6_vals = np.unique(np.concatenate([
            v6_vals, rng.integers(0, 1 << 40, n_v6, dtype=np.int64)
        ]))
    v6_vals = v6_vals[:n_v6]
    ifx = np.asarray(ifindexes, np.int64)[rng.integers(0, len(ifindexes), n_entries)]
    ip = np.zeros((n_entries, 16), np.uint8)
    # v4 /24: value << 8 as the first 4 big-endian bytes
    ip[:n_v4, :4] = (v4_vals << 8).astype(">u4").view(np.uint8).reshape(n_v4, 4)
    # v6 /48: the 0x20 byte and the 40-bit value in bytes 1..5
    v6_hi = (np.int64(0x20) << 40) | v6_vals
    ip[n_v4:, :6] = v6_hi.astype(">u8").view(np.uint8).reshape(n_v6, 8)[:, 2:]
    plen = np.empty(n_entries, np.int32)
    plen[:n_v4] = 24 + 32
    plen[n_v4:] = 48 + 32
    rules = np.zeros((n_entries, width, 7), np.int32)
    rules[:, 1, 0] = 1
    rules[:, 1, 1] = IPPROTO_TCP
    rules[:, 1, 2] = 70 + (np.arange(n_entries) % 60000)
    rules[:, 1, 6] = 2  # ALLOW
    return TableColumns(prefix_len=plen, ifindex=ifx, ip=ip, rules=rules)


def clean_tables_scale(
    rng: np.random.Generator,
    n_entries: int,
    ifindexes: Tuple[int, ...] = (2, 3),
    width: int = 4,
    v6_fraction: float = 0.3,
) -> CompiledTables:
    """clean_columns_fast through the columnar compiler."""
    return compile_tables_from_columns(
        clean_columns_fast(rng, n_entries, ifindexes, width, v6_fraction), rule_width=width
    )


def clean_tables_fast(
    rng: np.random.Generator,
    n_entries: int,
    ifindexes: Tuple[int, ...] = (2, 3),
    width: int = 4,
    v6_fraction: float = 0.3,
) -> CompiledTables:
    """The JAX package's ``clean_tables_fast`` (the tenant bench's 1M-entry
    swap pair): it draws the same numbers as clean_columns_fast, and its
    content dict compiles to the same tables as the columns do, so this is
    the columnar build."""
    return clean_tables_scale(rng, n_entries, ifindexes, width, v6_fraction)


def random_batch_fast(
    rng: np.random.Generator,
    tables: CompiledTables,
    n_packets: int,
    extra_ifindexes: Tuple[int, ...] = (9,),
    hit_fraction: float = 0.7,
) -> PacketBatch:
    """Vectorized packets biased toward table hits (address sampled from a
    random entry, bits flipped beyond — or occasionally inside — the mask)
    and toward rule-match boundaries (protocol/port copied from a random
    populated rule of that entry)."""
    b = n_packets
    T = int(tables.num_entries)
    kind = rng.choice([0, 1, 2, 3], size=b, p=[0.02, 0.55, 0.4, 0.03]).astype(np.int32)
    l4_ok = (rng.random(b) > 0.05).astype(np.int32)
    all_if = np.unique(
        np.concatenate([tables.key_words[:T, 0].astype(np.int64),
                        np.asarray(extra_ifindexes, np.int64)])
    )
    ifindex = all_if[rng.integers(0, len(all_if), b)].astype(np.int32)
    ip = rng.integers(0, 256, (b, 16), dtype=np.uint8)
    proto = np.asarray([6, 17, 132, 1, 58, 47, 0])[rng.integers(0, 7, b)].astype(np.int32)
    dst_port = rng.integers(0, 65536, b).astype(np.int32)
    icmp_type = rng.integers(0, 256, b).astype(np.int32)
    icmp_code = rng.integers(0, 3, b).astype(np.int32)

    hit = rng.random(b) < (hit_fraction if T else 0.0)
    if T:
        e = rng.integers(0, T, b)
        ent_ip = (
            tables.key_words[:T, 1:5].astype(">u4").copy().view(np.uint8).reshape(T, 16)
        )
        ent_mask = tables.mask_len[:T].astype(np.int64)
        ent_if = tables.key_words[:T, 0].astype(np.int32)
        m = ent_mask[e]
        hip = ent_ip[e].copy()
        beyond_ok = m < 128
        bit_beyond = (m + (rng.integers(0, 1 << 16, b) % np.maximum(128 - m, 1)))
        inside = (rng.random(b) < 0.3) & (m > 0)
        bit_inside = rng.integers(0, 1 << 16, b) % np.maximum(m, 1)
        bit = np.where(inside, bit_inside, np.where(beyond_ok, bit_beyond, 0))
        do_flip = beyond_ok | inside
        byte_i, mask_v = (bit // 8).astype(np.int64), (0x80 >> (bit % 8)).astype(np.uint8)
        sel = np.where(hit & do_flip)[0]
        hip[sel, byte_i[sel]] ^= mask_v[sel]
        ip[hit] = hip[hit]
        ifindex = np.where(hit & (rng.random(b) < 0.9), ent_if[e], ifindex)
        is_v4_key = (ent_mask[e] <= 32) & ~np.any(hip[:, 4:] != 0, axis=1)
        kind = np.where(
            hit & is_v4_key & (rng.random(b) < 0.8), 1,
            np.where(hit & ~is_v4_key & (rng.random(b) < 0.8), 2, kind),
        ).astype(np.int32)
        R = tables.rules.shape[1]
        ridx = rng.integers(0, R, b)
        rule = tables.rules[np.clip(e, 0, T - 1), ridx]  # (b, 7)
        has_rule = rule[:, 0] != 0
        use_rule = hit & has_rule & (rng.random(b) < 0.8)
        rproto = rule[:, 1]
        proto = np.where(use_rule & (rproto != 0), rproto, proto)
        is_tr = (rproto == IPPROTO_TCP) | (rproto == IPPROTO_UDP) | (rproto == IPPROTO_SCTP)
        jitter = rng.integers(-1, 2, b)
        port_single = np.clip(rule[:, 2] + jitter, 0, 65535)
        edge = np.stack([
            rule[:, 2] - 1, rule[:, 2], rule[:, 3] - 1, rule[:, 3], rule[:, 3] + 1
        ], 1)[np.arange(b), rng.integers(0, 5, b)]
        port_range = np.clip(edge, 0, 65535)
        dst_port = np.where(
            use_rule & is_tr,
            np.where(rule[:, 3] == 0, port_single, port_range),
            dst_port,
        ).astype(np.int32)
        is_ic = (rproto == IPPROTO_ICMP) | (rproto == IPPROTO_ICMPV6)
        icmp_type = np.where(
            use_rule & is_ic, rule[:, 4] + rng.integers(0, 2, b), icmp_type
        ).astype(np.int32)
        icmp_code = np.where(use_rule & is_ic, rule[:, 5], icmp_code).astype(np.int32)

    ip[kind == 1, 4:] = 0
    words = np.ascontiguousarray(ip).view(">u4").astype(np.uint32).reshape(b, 4)
    return PacketBatch(
        kind=kind,
        l4_ok=l4_ok,
        ifindex=ifindex,
        ip_words=words,
        proto=proto,
        dst_port=dst_port.astype(np.int32),
        icmp_type=icmp_type,
        icmp_code=icmp_code,
        pkt_len=rng.integers(60, 1500, b).astype(np.int32),
    )


def poisson_arrivals(rng: np.random.Generator, rate_pps: float, n: int) -> np.ndarray:
    """(n,) float64 cumulative arrival offsets (seconds) of a Poisson
    process at ``rate_pps``: exponential gaps, the same per (seeded rng,
    rate, n) as infw.testing's."""
    if rate_pps <= 0:
        raise ValueError(f"rate must be positive, got {rate_pps}")
    return np.cumsum(rng.exponential(1.0 / float(rate_pps), int(n)))


def burst_arrivals(rng: np.random.Generator, rate_pps: float, n: int,
                   burst: int = 64) -> np.ndarray:
    """(n,) float64 arrival offsets at the same mean rate as
    poisson_arrivals, in back-to-back groups of ``burst`` packets with
    exponential gaps (mean burst / rate) between groups."""
    if rate_pps <= 0:
        raise ValueError(f"rate must be positive, got {rate_pps}")
    burst = max(1, int(burst))
    n = int(n)
    starts = np.cumsum(rng.exponential(burst / float(rate_pps), -(-n // burst)))
    return np.repeat(starts, burst)[:n]


def flow_locality_fids(
    rng: np.random.Generator, n: int, established_fraction: float,
    chunk_packets: int = 1024,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """The chunk-aware flow ids under flow_trace_batch: (fid, fresh,
    n_flows), where ``fresh`` marks first occurrences and a repeat only
    names a flow born in an EARLIER chunk, so a verdict cache that inserts
    at chunk boundaries sees about ``established_fraction`` hits in every
    chunk after the first (chunk 0 is all fresh)."""
    n = int(n)
    e = float(established_fraction)
    if not 0.0 <= e < 1.0:
        raise ValueError(f"established_fraction must be in [0, 1), got {e}")
    cp = max(int(chunk_packets), 1)
    chunk = np.arange(n) // cp
    chunk_starts = np.arange(0, n, cp)
    fresh = (rng.random(n) >= e) | (chunk == 0)
    seen = np.cumsum(fresh)
    born_before = np.concatenate([[0], seen[chunk_starts[1:] - 1]])[chunk]
    fresh = fresh | (born_before == 0)
    seen = np.cumsum(fresh)
    born_before = np.concatenate([[0], seen[chunk_starts[1:] - 1]])[chunk]
    pick = rng.random(n)
    fid = np.where(
        fresh, seen - 1, (pick * np.maximum(born_before, 1)).astype(np.int64),
    ).astype(np.int64)
    return fid, fresh, int(seen[-1])


def flow_trace_batch(
    rng: np.random.Generator,
    tables: CompiledTables,
    n_packets: int,
    established_fraction: float,
    chunk_packets: int = 1024,
    fin_fraction: float = 0.05,
) -> Tuple[PacketBatch, Dict[str, int]]:
    """Seeded packet stream with a set share of established flows, the
    flow tier's hit-rate ladder: in every chunk of ``chunk_packets``
    after the first, about ``established_fraction`` of the packets repeat
    a flow born in an earlier chunk.  Flows come from random_batch_fast
    over ``tables``, repaired to IPv4/IPv6 lanes with l4_ok = 1.  TCP
    flags: SYN on a flow's first packet, ACK after, FIN|ACK on the last
    packet of ``fin_fraction`` of the flows.  Returns (batch, {"n_flows",
    "repeats"}); the batch carries ``tcp_flags``."""
    n = int(n_packets)
    fid, fresh, n_flows = flow_locality_fids(rng, n, established_fraction, chunk_packets)
    pool = random_batch_fast(rng, tables, n_flows)
    kind = np.asarray(pool.kind)
    kind = np.where((kind == 1) | (kind == 2), kind, 1).astype(np.int32)
    v4 = kind == 1
    ipw = np.asarray(pool.ip_words).copy()
    ipw[v4, 1:] = 0
    batch = PacketBatch(
        kind=kind[fid],
        l4_ok=np.ones(n, np.int32),
        ifindex=np.asarray(pool.ifindex)[fid],
        ip_words=ipw[fid],
        proto=np.asarray(pool.proto)[fid],
        dst_port=np.asarray(pool.dst_port)[fid],
        icmp_type=np.asarray(pool.icmp_type)[fid],
        icmp_code=np.asarray(pool.icmp_code)[fid],
        pkt_len=rng.integers(60, 1500, n).astype(np.int32),
    )
    is_tcp = batch.proto == IPPROTO_TCP
    flags = np.where(is_tcp, TCP_ACK, 0).astype(np.int32)
    flags[fresh & is_tcp] = TCP_SYN
    last = np.zeros(n_flows, np.int64)
    np.maximum.at(last, fid, np.arange(n, dtype=np.int64))
    closing = last[rng.random(n_flows) < fin_fraction]
    closing = closing[is_tcp[closing]]
    flags[closing] = TCP_FIN | TCP_ACK
    batch.tcp_flags = flags
    return batch, {"n_flows": n_flows, "repeats": int(n - n_flows)}


# --- adversarial attack traces (the telemetry tier's workload) ---------------

ATTACK_MODES = ("synflood", "portscan", "denystorm")


def attack_trace_batch(
    rng: np.random.Generator,
    tables: CompiledTables,
    n_packets: int,
    mode: str = "synflood",
    attack_fraction: float = 0.4,
    attack_start: float = 0.25,
    chunk_packets: int = 1024,
    n_attackers: int = 2,
) -> Tuple[PacketBatch, Dict[str, object]]:
    """Seeded adversarial traffic for the telemetry plane: background
    traffic with flow locality (flow_trace_batch at 50% established)
    carrying an attack that begins at ``attack_start`` of the stream
    (rounded down to a chunk boundary) and claims ``attack_fraction`` of
    the lanes from then on.

    Modes: ``synflood`` (``n_attackers`` IPv4 sources send pure-SYN TCP to
    one port), ``portscan`` (one IPv4 source sweeps destination ports),
    ``denystorm`` (attackers replay packets the oracle says this ruleset
    denies).  Byte-identical to the JAX package's generator for the same
    seeded rng and arguments.  Returns (batch, meta) with meta = {"mode",
    "start", "n_attack", "attackers": [(ip_words row, kind)],
    "attack_mask", "n_flows"}."""
    if mode not in ATTACK_MODES:
        raise ValueError(f"unknown attack mode {mode!r} (expected one of {ATTACK_MODES})")
    n = int(n_packets)
    batch, meta = flow_trace_batch(rng, tables, n, 0.5, chunk_packets=chunk_packets)
    cp = max(int(chunk_packets), 1)
    start = (int(n * float(attack_start)) // cp) * cp
    mask = (np.arange(n) >= start) & (rng.random(n) < float(attack_fraction))
    k = int(mask.sum())
    flags = np.asarray(batch.tcp_flags, np.int32)
    attackers: List[Tuple[np.ndarray, int]] = []
    if mode in ("synflood", "portscan"):
        n_src = 1 if mode == "portscan" else max(1, int(n_attackers))
        srcs = np.zeros((n_src, 4), np.uint32)
        srcs[:, 0] = rng.integers(1, 1 << 32, n_src, dtype=np.uint64)
        lane_src = np.arange(k) % n_src
        batch.kind[mask] = 1
        batch.l4_ok[mask] = 1
        batch.ip_words[mask] = srcs[lane_src]
        batch.proto[mask] = IPPROTO_TCP
        batch.icmp_type[mask] = 0
        batch.icmp_code[mask] = 0
        if mode == "synflood":
            batch.dst_port[mask] = 443
            flags[mask] = TCP_SYN  # pure SYN, never promotes
        else:
            batch.dst_port[mask] = np.arange(k) % 65536
            flags[mask] = TCP_ACK
        attackers = [(srcs[i].copy(), 1) for i in range(n_src)]
    else:  # denystorm: oracle-confirmed deny lanes, replayed verbatim
        from . import oracle

        pool = random_batch_fast(rng, tables, max(4 * n_attackers, 256))
        ref = oracle.classify(tables, pool)
        deny = np.nonzero((ref.results & 0xFF) == 1)[0]
        if len(deny) == 0:
            raise ValueError("denystorm needs at least one oracle-DENY lane in the "
                             "table-biased pool; got none (all-allow ruleset?)")
        picks = deny[: max(1, int(n_attackers))]
        lane_src = np.arange(k) % len(picks)
        for f in ("kind", "l4_ok", "ifindex", "ip_words", "proto", "dst_port", "icmp_type",
                  "icmp_code"):
            getattr(batch, f)[mask] = np.asarray(getattr(pool, f))[picks][lane_src]
        flags[mask] = np.where(np.asarray(pool.proto)[picks][lane_src] == IPPROTO_TCP,
                               TCP_ACK, 0)
        attackers = [(np.asarray(pool.ip_words)[i].copy(), int(np.asarray(pool.kind)[i]))
                     for i in picks]
    batch.tcp_flags = flags
    return batch, {
        "mode": mode, "start": int(start), "n_attack": k, "attackers": attackers,
        "attack_mask": mask, "n_flows": meta["n_flows"],
    }


#: the named cases of flow_kernel_case
FLOW_KERNEL_CASES = (
    "fin_rst_same_slot", "teardown_then_hit", "duplicate_keys", "full_slab_tied_epochs",
    "syn_then_ack_promote", "ways_1", "ways_8", "tenant_ranges", "epoch_near_int32_max",
    "inert_lanes", "stale_generation", "hot_slot", "warp_mixed_slots", "lanes_beyond_grid",
    # the way counts the kernels serve through a wider template's guards
    # (3, 5, 6, 7) or a template of their own (2); default cases are 4-way
    "ways_2", "ways_3", "ways_5", "ways_6", "ways_7",
)
#: lanes of the cases whose batch is not the default 96: "lanes_beyond_grid"
#: holds more lanes than the threads an H100 keeps resident (132 SMs x 2048)
FLOW_CASE_LANES = {"hot_slot": 512, "warp_mixed_slots": 256, "lanes_beyond_grid": 300_007}


def _flow_pool(rng: np.random.Generator, n: int, width: int) -> PacketBatch:
    """``n`` distinct eligible flows (IPv4 only for the 4-word wire)."""
    kind = np.ones(n, np.int32) if width == 4 else rng.choice([1, 2], n).astype(np.int32)
    ip = rng.integers(0, 1 << 32, (n, 4), dtype=np.uint64).astype(np.uint32)
    ip[kind == 1, 1:] = 0
    proto = rng.choice([IPPROTO_TCP, IPPROTO_TCP, IPPROTO_UDP, IPPROTO_ICMP], n).astype(np.int32)
    icmp = proto == IPPROTO_ICMP
    return PacketBatch(
        kind=kind, l4_ok=np.ones(n, np.int32), ifindex=rng.choice([2, 3], n).astype(np.int32),
        ip_words=ip, proto=proto,
        dst_port=np.where(icmp, 0, rng.integers(0, 65536, n)).astype(np.int32),
        icmp_type=np.where(icmp, rng.integers(0, 256, n), 0).astype(np.int32),
        icmp_code=np.where(icmp, rng.integers(0, 256, n), 0).astype(np.int32),
        pkt_len=rng.integers(60, 1500, n).astype(np.int32),
    )


def _wire_of(b: PacketBatch, width: int) -> np.ndarray:
    return b.pack_wire_v4() if width == 4 else b.pack_wire()


def flow_kernel_case(name: str, width: int, seed: int = 0) -> Dict[str, object]:
    """One probe-then-insert scenario of the flow kernels (K7, K8) from a
    seed: the geometry (``entries``, ``pages``, ``ways``, ``max_age``),
    the starting state (``keys`` uint32 (C, 8), ``vg``, ``se``, ``cnt``,
    ``gens``, ``page_table``), then ``probe`` = (wire, tenant, tflags,
    epoch) and ``insert`` = (wire, tenant, tflags, verdict, epoch), the
    insert running on the columns the probe left.  ``width`` is the wire
    width, 4 or 7.  The starting columns come from inserting a pool of
    flows into an empty table with the host model
    (infw_torch.flow.HostFlowModel)."""
    from .flow import FlowConfig, HostFlowModel

    if name not in FLOW_KERNEL_CASES or width not in (4, 7):
        raise ValueError(f"unknown flow kernel case {name!r} / width {width}")
    rng = np.random.default_rng([seed, FLOW_KERNEL_CASES.index(name), width])
    entries, pages, ways, tenants, max_age = 64, 1, 4, 1, 1 << 20
    if name.startswith("ways_"):
        ways = int(name[len("ways_"):])
    elif name == "full_slab_tied_epochs":
        entries = 8
    elif name == "tenant_ranges":
        pages, tenants = 2, 3
    elif name == "epoch_near_int32_max":
        max_age = 67  # two of the four seeding epochs stay fresh
    cfg = FlowConfig.make(entries=entries, pages=pages, ways=ways, max_tenants=tenants,
                          max_age=max_age)
    model = HostFlowModel(cfg)
    if name == "tenant_ranges":
        model.page_table[:] = [0, -1, 1]  # tenant 1 has no flow slab
    model.gens[:] = rng.integers(0, 5, tenants)
    n_pool = 40
    pool = _flow_pool(rng, n_pool, width)
    pool_tenant = rng.integers(0, tenants, n_pool).astype(np.int32)
    epoch0 = (1 << 31) - 70 if name == "epoch_near_int32_max" else 100
    seed_flags = np.where(pool.proto == IPPROTO_TCP,
                          TCP_SYN if name == "syn_then_ack_promote" else TCP_ACK, 0)
    if name != "full_slab_tied_epochs":
        for k in range(4):  # the pool in four inserts at four epochs
            idx = np.arange(k, n_pool, 4)
            sub = pool.take(idx)
            model.insert(_wire_of(sub, width), pool_tenant[idx], seed_flags[idx],
                         rng.integers(0, 1 << 16, len(idx)), epoch0 + k)
    else:
        live = rng.integers(0, 1 << 32, (cfg.capacity, 8), dtype=np.uint64).astype(np.uint32)
        model.keys[:] = live
        model.se[:, 0] = 2
        model.se[:, 1] = epoch0  # every way ties on the oldest epoch
    if name == "stale_generation":
        # a new generation, then half the pool re-inserted under it: the
        # other half matches, live and fresh, under the old one
        model.gens += 1
        idx = np.arange(0, n_pool, 2)
        model.insert(_wire_of(pool.take(idx), width), pool_tenant[idx], seed_flags[idx],
                     rng.integers(0, 1 << 16, len(idx)), epoch0 + 4)
    if name == "epoch_near_int32_max":
        # entries last seen "before" the wrap: their int32 difference to
        # the probe's epoch wraps to -6, so they count as fresh
        live = np.nonzero(model.se[:, 0] > 0)[0]
        model.se[live[::3], 1] = np.int32(-(1 << 31) + 5)

    B = FLOW_CASE_LANES.get(name, 96)
    pick = rng.integers(0, n_pool, B)
    fresh = _flow_pool(rng, B, width)
    use_fresh = rng.random(B) < 0.3
    lanes = PacketBatch(**{
        f: np.where(use_fresh.reshape((-1,) + (1,) * (getattr(pool, f).ndim - 1)),
                    getattr(fresh, f), getattr(pool, f)[pick])
        for f in ("kind", "l4_ok", "ifindex", "ip_words", "proto", "dst_port", "icmp_type",
                  "icmp_code")
    }, pkt_len=rng.integers(60, 0x1FFFFF, B).astype(np.int32))
    tenant = np.where(use_fresh, rng.integers(0, tenants, B), pool_tenant[pick]).astype(np.int32)
    is_tcp = lanes.proto == IPPROTO_TCP
    tflags = np.where(is_tcp, rng.choice([0, TCP_ACK, TCP_SYN, TCP_SYN | TCP_ACK], B), 0)
    if name == "fin_rst_same_slot":
        tcp_pool = np.nonzero(pool.proto == IPPROTO_TCP)[0]
        # lanes 0-3 FIN and 4-7 RST one flow, 8-11 ACK and 12-15 FIN another
        for j, f in enumerate((TCP_FIN | TCP_ACK, TCP_RST, TCP_ACK, TCP_FIN)):
            pick_j = tcp_pool[j // 2]
            for fld in ("kind", "l4_ok", "ifindex", "proto", "dst_port", "icmp_type", "icmp_code"):
                getattr(lanes, fld)[4 * j: 4 * j + 4] = getattr(pool, fld)[pick_j]
            lanes.ip_words[4 * j: 4 * j + 4] = pool.ip_words[pick_j]
            tenant[4 * j: 4 * j + 4] = pool_tenant[pick_j]
            tflags[4 * j: 4 * j + 4] = f
    elif name == "teardown_then_hit":
        tcp_pool = np.nonzero(pool.proto == IPPROTO_TCP)[0]
        for j, lane in enumerate((0, 50, 95)):
            fl = tcp_pool[0]
            for fld in ("kind", "l4_ok", "ifindex", "proto", "dst_port", "icmp_type", "icmp_code"):
                getattr(lanes, fld)[lane] = getattr(pool, fld)[fl]
            lanes.ip_words[lane] = pool.ip_words[fl]
            tenant[lane] = pool_tenant[fl]
            tflags[lane] = TCP_RST if j == 0 else TCP_ACK
    elif name == "duplicate_keys":
        dup = fresh.take(np.arange(3))
        for lane in range(B):
            if lane % 3 == 0:
                d = lane % 9 // 3
                for fld in ("kind", "l4_ok", "ifindex", "proto", "dst_port", "icmp_type",
                            "icmp_code"):
                    getattr(lanes, fld)[lane] = getattr(dup, fld)[d]
                lanes.ip_words[lane] = dup.ip_words[d]
                tenant[lane] = 0
    elif name in ("hot_slot", "warp_mixed_slots"):
        # the TCP flows of the pool that the seeding left live: a probe of
        # a copy of the model
        _res, live, _h, _s = copy.deepcopy(model).probe(
            _wire_of(pool, width), pool_tenant, np.zeros(n_pool, np.int32), epoch0 + 10)
        tcp_pool = np.nonzero((pool.proto == IPPROTO_TCP) & live)[0]
        if name == "hot_slot":
            # three lanes in four one live TCP flow, with every flag mix:
            # its counters summed across warps, FIN's max and RST's min on
            # one slot, and the insert's last lane on it
            flows = np.where(rng.random(B) < 0.75, tcp_pool[0], -1)
        else:
            # each warp's lanes over two or three live flows, interleaved
            flows = np.concatenate([
                rng.choice(tcp_pool, n, replace=False)[np.arange(32) % n]
                for n in rng.integers(2, 4, B // 32)])
            flows[rng.random(B) < 0.1] = -1
        on = flows >= 0
        for fld in ("kind", "l4_ok", "ifindex", "proto", "dst_port", "icmp_type", "icmp_code"):
            getattr(lanes, fld)[on] = getattr(pool, fld)[flows[on]]
        lanes.ip_words[on] = pool.ip_words[flows[on]]
        tenant[on] = pool_tenant[flows[on]]
        is_tcp = lanes.proto == IPPROTO_TCP
        mix = [TCP_ACK, TCP_ACK, TCP_SYN, TCP_SYN | TCP_ACK, TCP_FIN | TCP_ACK, TCP_RST, 0]
        tflags = np.where(is_tcp, rng.choice(mix, B), 0)
    elif name == "syn_then_ack_promote":
        tflags = np.where(is_tcp, TCP_ACK, 0)
    elif name == "tenant_ranges":
        tenant = rng.choice([-1, 0, 1, 2, 3, 7], B).astype(np.int32)
        tenant[: B // 2] = np.where(use_fresh, tenant, pool_tenant[pick])[: B // 2]
    elif name == "inert_lanes":
        odd = rng.random(B) < 0.4
        lanes.kind[odd & (rng.random(B) < 0.5)] = 3   # KIND_OTHER
        lanes.l4_ok[odd & (rng.random(B) < 0.5)] = 0
        lanes.kind[odd & (rng.random(B) < 0.2)] = 0   # malformed
    tflags = np.asarray(tflags, np.int32)
    wire = _wire_of(lanes, width)
    epoch = epoch0 + 10 if name != "epoch_near_int32_max" else (1 << 31) - 1
    verdict = rng.integers(0, 1 << 20, B).astype(np.uint32)
    return {
        "entries": cfg.entries, "pages": cfg.pages, "ways": cfg.ways, "max_age": cfg.max_age,
        "keys": model.keys.copy(), "vg": model.vg.copy(), "se": model.se.copy(),
        "cnt": model.cnt.copy(), "gens": model.gens.copy(), "page_table": model.page_table.copy(),
        "probe": (wire, tenant, tflags, epoch),
        "insert": (wire, tenant, tflags, verdict, epoch),
    }


#: the packet orders of depth_adversarial
DEPTH_PATTERNS = ("full_depth", "alternating", "one_deep_per_32", "root_only")
#: the node rows a deep packet of depth_adversarial reads on either walk
#: (K2 at its 15 levels, K3 with d_max at least this)
DEEP_ROWS = 14


def depth_adversarial(
    rng: np.random.Generator,
    n_packets: int,
    pattern: str,
    ifindexes: Tuple[int, ...] = (2, 3, 4),
    width: int = 8,
    leaves: int = 16,
) -> Tuple[CompiledTables, PacketBatch, np.ndarray]:
    """A table and a batch that make the trie and ctrie walks diverge within
    a warp, with every packet's walk depth known by construction.

    Per ifindex, one IPv6 chain: an entry at every 8-bit boundary from /24
    to /120 along one address and ``leaves`` /128 entries under the /120.
    Every level below the DIR-16 root then holds a node with a target, so
    no skip node compresses the chain, and a packet at a leaf reads
    DEEP_ROWS node rows on both walks (K2 at 1 + d levels reads min(d,
    DEEP_ROWS)).  Beside it one IPv4 /8 (10/8), whose DIR-16 slots hold a
    target and no child.  Deep packets are IPv6 at a random leaf of their
    ifindex's chain; root-only packets are IPv4 under 10/8 (a match at the
    root) or under 11/8 (no entry), and leave at the DIR-16 slot having
    read no node row.  Protocol, port and ICMP fields copy a random rule of
    the entry the packet matches, 80% of the time.

    ``pattern`` orders deep and root-only packets (DEPTH_PATTERNS):
    "full_depth" every packet deep, "alternating" deep on even positions,
    "one_deep_per_32" deep at every position divisible by 32, "root_only"
    none deep.  Returns (tables, batch, deep), ``deep`` the (B,) bool mask
    of the deep packets."""
    if pattern not in DEPTH_PATTERNS:
        raise ValueError(f"pattern {pattern!r} not in {DEPTH_PATTERNS}")
    n_if = len(ifindexes)
    chain_lens = list(range(24, 128, 8))
    n_chain = len(chain_lens) + leaves
    # per ifindex: the chain entries, the leaves, then the /8
    per_if = n_chain + 1
    rules = random_rules_bulk(rng, n_if * per_if, width)
    content: Dict[LpmKey, np.ndarray] = {}
    leaf_ip = np.zeros((n_if, leaves, 16), np.uint8)
    for k, ifx in enumerate(ifindexes):
        base = rng.integers(0, 256, 16, dtype=np.uint8)
        base[0] = 0x20
        keys = [(m, base) for m in chain_lens]
        for j in range(leaves):
            ip = base.copy()
            ip[15] = j
            leaf_ip[k, j] = ip
            keys.append((128, ip))
        keys.append((8, np.array([10] + [0] * 15, np.uint8)))
        for e, (m, ip) in enumerate(keys):
            content[LpmKey(prefix_len=m + 32, ingress_ifindex=int(ifx),
                           ip_data=bytes(ip))] = rules[k * per_if + e]
    tables = compile_tables_from_content(content, rule_width=width)

    b = n_packets
    pos = np.arange(b)
    deep = {"full_depth": np.ones(b, bool), "alternating": pos % 2 == 0,
            "one_deep_per_32": pos % 32 == 0, "root_only": np.zeros(b, bool)}[pattern]
    k = rng.integers(0, n_if, b)
    leaf = rng.integers(0, leaves, b)
    hit_root = rng.random(b) < 0.5
    ip = rng.integers(0, 256, (b, 16), dtype=np.uint8)
    ip[:, 0] = np.where(hit_root, 10, 11)
    ip[:, 4:] = 0
    ip[deep] = leaf_ip[k[deep], leaf[deep]]
    entry = k * per_if + np.where(deep, len(chain_lens) + leaf, n_chain)
    rule = rules[entry, rng.integers(0, width, b)]
    use = (rule[:, 0] != 0) & (rng.random(b) < 0.8) & (deep | hit_root)
    proto = np.asarray(_PROTOS)[rng.integers(0, len(_PROTOS), b)]
    proto = np.where(use & (rule[:, 1] != 0), rule[:, 1], proto).astype(np.int32)
    return tables, PacketBatch(
        kind=np.where(deep, 2, 1).astype(np.int32),
        l4_ok=np.ones(b, np.int32),
        ifindex=np.asarray(ifindexes, np.int32)[k],
        ip_words=np.ascontiguousarray(ip).view(">u4").astype(np.uint32).reshape(b, 4),
        proto=proto,
        dst_port=np.where(use, rule[:, 2], rng.integers(0, 65536, b)).astype(np.int32),
        icmp_type=np.where(use, rule[:, 4], rng.integers(0, 256, b)).astype(np.int32),
        icmp_code=np.where(use, rule[:, 5], rng.integers(0, 3, b)).astype(np.int32),
        pkt_len=rng.integers(60, 1500, b).astype(np.int32),
    ), deep


def stats_dict_from_array(stats4: np.ndarray) -> Dict[int, List[int]]:
    """(MAX_TARGETS, 4) int64 -> {ruleId: [ap, ab, dp, db]} with zero rows
    dropped, for comparison against the oracle's dict."""
    return {
        int(rid): [int(x) for x in stats4[rid]]
        for rid in np.nonzero(stats4.any(axis=1))[0]
    }


def random_nodestate(rng: np.random.Generator, name: str, interfaces: Dict[str, int],
                     n_cidrs: int, width: int = 8, blocks: int = 4,
                     deny_share: float = 0.5) -> dict:
    """A NodeState CR dict (ingressnodefirewallnodestate_types.go) holding
    about ``n_cidrs`` LPM entries: each interface gets ``blocks`` ingress
    blocks of its own source CIDRs (two IPv4 /20-/32 for each IPv6
    /32-/128, host bits set) with rules at orders 1..width-1 (TCP, UDP and
    SCTP ports and ranges, ICMP, ICMPv6, a catch-all last), each Deny with
    probability ``deny_share``, else Allow.  ``interfaces`` maps names to ifindexes, which only fix the
    iteration order; the daemon's registry resolves the names."""
    rules_of_iface = {}
    per_block = max(1, n_cidrs // (len(interfaces) * blocks))
    for iface in interfaces:
        ingress = []
        for _ in range(blocks):
            v4 = rng.integers(0, 1 << 32, per_block, dtype=np.uint64)
            v6 = rng.integers(0, 1 << 16, (per_block, 8))
            plen4 = rng.integers(20, 33, per_block)
            plen6 = rng.choice([32, 48, 64, 96, 128], per_block)
            is6 = rng.random(per_block) < 1 / 3
            cidrs = [
                ":".join(f"{int(w):x}" for w in v6[i]) + f"/{int(plen6[i])}" if is6[i]
                else ".".join(str((int(v4[i]) >> s) & 0xFF) for s in (24, 16, 8, 0))
                + f"/{int(plen4[i])}"
                for i in range(per_block)
            ]
            rules = []
            for order in range(1, width):
                action = "Deny" if rng.random() < deny_share else "Allow"
                kind = int(rng.integers(0, 6)) if order < width - 1 else 6
                start = int(rng.integers(20000, 60000))
                if kind < 3:
                    proto = ("TCP", "UDP", "SCTP")[kind]
                    ports = start if rng.random() < 0.5 else f"{start}-{start + int(rng.integers(1, 3000))}"
                    cfg = {"protocol": proto, proto.lower(): {"ports": ports}}
                elif kind == 3:
                    cfg = {"protocol": "ICMP", "icmp": {"icmpType": int(rng.integers(0, 20)),
                                                        "icmpCode": int(rng.integers(0, 3))}}
                elif kind == 4:
                    cfg = {"protocol": "ICMPv6", "icmpv6": {"icmpType": int(rng.integers(128, 140)),
                                                            "icmpCode": 0}}
                elif kind == 5:
                    cfg = {"protocol": "TCP", "tcp": {"ports": "1-30000"}}
                else:
                    cfg = {"protocol": ""}
                rules.append({"order": order, "protocolConfig": cfg, "action": action})
            ingress.append({"sourceCIDRs": cidrs, "rules": rules})
        rules_of_iface[iface] = ingress
    return {
        "apiVersion": "ingressnodefirewall.tpu/v1alpha1",
        "kind": "IngressNodeFirewallNodeState",
        "metadata": {"name": name, "namespace": "ingress-node-firewall-system"},
        "spec": {"interfaceIngressRules": rules_of_iface},
    }


#: the edit generator's op mix, the JAX package's tools/churngen.py OP_MIX:
#: (kind, probability); "readd" expands to the re-add of a deleted key
EDIT_OP_MIX = (
    ("rules_edit", 0.70),
    ("cidr_add", 0.15),
    ("key_delete", 0.10),
    ("readd", 0.05),
)


def generate_edit_ops(rng: np.random.Generator, n: int, tables, width: int) -> list:
    """A seeded edit stream (txn.EditOp) over ``tables.content``'s live
    keys with EDIT_OP_MIX, the JAX package's tools/churngen.py generate_ops:
    keys leave on delete and return on re-add, so the stream never edits a
    dead identity; a cidr_add is a fresh /24 from 198.18.0.0 up on ifindex
    2.  One difference: churngen counts its serial in the fourth byte, which
    the /24 masks away, so all but one cidr_add in 256 collide and are
    drawn again; here the serial fills the second and third bytes, so the
    stream holds the mix's share of new CIDRs."""
    from .txn import EditOp

    live = list(tables.content)
    idents = {k.masked_identity() for k in live}
    deleted: list = []
    kinds = [k for k, _p in EDIT_OP_MIX]
    probs = np.array([p for _k, p in EDIT_OP_MIX])
    probs /= probs.sum()
    ops = []
    serial = 0
    while len(ops) < n:
        kind = str(rng.choice(kinds, p=probs))
        if kind in ("rules_edit", "key_delete") and not live:
            kind = "cidr_add"
        if kind == "readd" and not deleted:
            kind = "key_delete" if live else "cidr_add"
        if kind == "rules_edit":
            k = live[int(rng.integers(0, len(live)))]
            ops.append(EditOp("rules_edit", k, random_rules(rng, width)))
        elif kind == "key_delete":
            k = live.pop(int(rng.integers(0, len(live))))
            idents.discard(k.masked_identity())
            deleted.append(k)
            ops.append(EditOp("key_delete", k))
        elif kind == "readd":
            k = deleted.pop(int(rng.integers(0, len(deleted))))
            if k.masked_identity() in idents:
                continue
            idents.add(k.masked_identity())
            live.append(k)
            ops.append(EditOp("key_add", k, random_rules(rng, width)))
        else:  # cidr_add: a fresh structural identity
            serial += 1
            k = LpmKey(prefix_len=56, ingress_ifindex=2,
                       ip_data=bytes([198, (18 + (serial >> 8)) & 0xFF, serial & 0xFF, 0])
                       + bytes(12))
            if k.masked_identity() in idents:
                continue
            idents.add(k.masked_identity())
            live.append(k)
            ops.append(EditOp("cidr_add", k, random_rules(rng, width)))
    return ops


def score_traffic(rng: np.random.Generator, tables, b: int, syn_frac: float = 0.3):
    """A (batch, 7-word wire, verdicts) admission for the scoring tier (the
    JAX package's tests/test_mlscore.py traffic, over random_batch_fast):
    ``syn_frac`` of the lanes carry a pure SYN, the rest an ACK, and each
    lane a random u32 verdict (action 0-2, ruleId 1-8)."""
    from .constants import TCP_ACK, TCP_SYN

    batch = random_batch_fast(rng, tables, b)
    batch.tcp_flags = np.where(rng.random(b) < syn_frac, TCP_SYN, TCP_ACK).astype(np.int32)
    res = (rng.integers(0, 3, b).astype(np.uint32)
           | (rng.integers(1, 9, b).astype(np.uint32) << 8))
    return batch, batch.pack_wire(), res


def random_score_model(rng: np.random.Generator, spec, qshift=(2, 5)):
    """A scoring model of random values at ``spec``'s geometry: thresholds
    in [0, 300) over random features, int8 leaves and weights, int32 biases
    over the whole range (so the head's sums wrap) and the given shifts."""
    from .kernels.mxu_score import default_model

    m = default_model(spec)
    H = spec.hidden
    i8 = lambda *shape: rng.integers(-128, 128, shape).astype(np.int8)  # noqa: E731
    i32 = lambda n: rng.integers(-2**31, 2**31, n).astype(np.int32)  # noqa: E731
    return m._replace(
        fidx=rng.integers(0, 16, m.fidx.shape).astype(np.int32),
        fthr=rng.integers(0, 300, m.fthr.shape).astype(np.int32),
        leaf=i8(m.leaf.shape[0]), w1=i8(16, H), b1=i32(H), w2=i8(H), b2=i32(1),
        qshift=np.asarray(qshift, np.int32), version="random")
