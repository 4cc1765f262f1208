"""Scalar NumPy oracle classifiers.

A direct, per-packet transliteration of the XDP program's semantics
(bpf/ingress_node_firewall_kernel.c:189-457) over the compiled table
*content* (the LPM key -> rule-rows map), independent of the tensor
encodings and of PyTorch.  The ground truth the port's main path is checked
against: ``classify`` indexes the table on every call, ``HashLpmOracle``
indexes it once for many batches of a large table.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from .compiler import CompiledTables
from .constants import (
    ALLOW,
    DENY,
    IPPROTO_ICMP,
    IPPROTO_ICMPV6,
    IPPROTO_SCTP,
    IPPROTO_TCP,
    IPPROTO_UDP,
    KIND_IPV4,
    KIND_MALFORMED,
    KIND_OTHER,
    MAX_TARGETS,
    UNDEF,
    V4_KEY_PREFIX_LEN,
    V6_KEY_PREFIX_LEN,
    XDP_DROP,
    XDP_PASS,
    set_actionrule_response,
)
from .packets import PacketBatch

_TRANSPORT = (IPPROTO_TCP, IPPROTO_UDP, IPPROTO_SCTP)


@dataclass
class ClassifyResult:
    """Per-batch outputs: packed u32 results (action | ruleId<<8), XDP
    verdicts, and statistics keyed by ruleId with [allow_packets,
    allow_bytes, deny_packets, deny_bytes] values (ruleStatistics_st,
    bpf/ingress_node_firewall.h:45-54)."""

    results: np.ndarray  # (B,) uint32
    xdp: np.ndarray      # (B,) int32
    stats: Dict[int, List[int]] = field(default_factory=dict)


LpmIndex = Dict[int, List[Tuple[int, Dict[int, int]]]]


def _lpm_index(entries: List[Tuple[int, int, int, int]]) -> LpmIndex:
    """(ifindex, mask_len, masked_ip_int, target) entries -> per ifindex,
    the mask lengths present, longest first, each with a dict from the
    prefix's top mask_len bits to its target.  Masked-identity dedup leaves
    one entry per (ifindex, mask_len, prefix)."""
    by_len: Dict[int, Dict[int, Dict[int, int]]] = {}
    for e_ifindex, e_mask_len, e_masked_ip, target in entries:
        by_len.setdefault(e_ifindex, {}).setdefault(e_mask_len, {})[
            e_masked_ip >> (128 - e_mask_len)
        ] = target
    return {ifx: sorted(lens.items(), reverse=True) for ifx, lens in by_len.items()}


def _lpm_lookup(index: LpmIndex, ifindex: int, ip_int: int, cap_prefix_len: int) -> int:
    """Longest-prefix match over the (ifindex || ip) key space: probe the
    ifindex's mask lengths from the longest down.  Entries with prefixLen
    (mask_len + 32) above the packet key's prefix length cannot match (BPF
    LPM trie lookup with the packet key of kernel.c:206-212 / 292-295)."""
    for mask_len, prefixes in index.get(ifindex, ()):
        if mask_len + 32 > cap_prefix_len:
            continue
        target = prefixes.get(ip_int >> (128 - mask_len))
        if target is not None:
            return target
    return -1


def _scan_rules(
    rows: np.ndarray, proto: int, dport: int, icmp_type: int, icmp_code: int, is_v4: bool
) -> int:
    """The ordered rule scan (kernel.c:222-258 / 305-340)."""
    icmp_proto = IPPROTO_ICMP if is_v4 else IPPROTO_ICMPV6
    for i in range(rows.shape[0]):
        rid, rproto, ps, pe, it, ic, act = (int(x) for x in rows[i])
        if rid == 0:  # INVALID_RULE_ID -> empty slot
            continue
        if rproto != 0 and rproto == proto:
            if rproto in _TRANSPORT:
                if pe == 0:
                    if ps == dport:
                        return set_actionrule_response(act, rid)
                else:
                    if ps <= dport < pe:
                        return set_actionrule_response(act, rid)
            if rproto == icmp_proto:
                if it == icmp_type and ic == icmp_code:
                    return set_actionrule_response(act, rid)
        if rproto == 0:
            # Protocol not set: catch-all (kernel.c:254-257).
            return set_actionrule_response(act, rid)
    return UNDEF


def _dedup_entries(tables: CompiledTables):
    """Masked-identity dedup of the table content.  Returns (entries,
    rules_by_target), entries being (ifindex, mask_len, masked_ip_int,
    target)."""
    dedup: Dict[Tuple[int, int, bytes], int] = {}
    ordered: List[Tuple[Tuple[int, int, int, int], np.ndarray]] = []
    for key, rows in tables.content.items():
        ident = key.masked_identity()
        e = (key.ingress_ifindex, key.mask_len, int.from_bytes(ident[2], "big"))
        if ident in dedup:
            ordered[dedup[ident]] = ((*e, dedup[ident]), rows)
        else:
            dedup[ident] = len(ordered)
            ordered.append(((*e, len(ordered)), rows))
    return [e for e, _ in ordered], [rows for _, rows in ordered]


def classify(tables: CompiledTables, batch: PacketBatch) -> ClassifyResult:
    """Reference classification of a whole batch, including the ethertype
    dispatch, stats and final XDP verdict of ingress_node_firewall_main
    (kernel.c:412-457)."""
    entries, rules_by_target = _dedup_entries(tables)
    index = _lpm_index(entries)
    return _classify_with_lookup(
        lambda ifindex, ip_int, cap: _lpm_lookup(index, ifindex, ip_int, cap),
        rules_by_target, batch,
    )


class HashLpmOracle:
    """LPM-by-hash oracle for the large tables (1M-10M entries): built
    once, then any number of batches.  The deduped entries are bucketed by
    mask length into hash maps keyed by (ifindex, prefix bits); a lookup
    probes the mask lengths longest first, O(distinct mask lengths) per
    packet.  It shares the entry dedup, the rule scan and the per-packet
    dispatch with ``classify``, and its lookup structure is independent of
    the tensor layouts."""

    def __init__(self, tables: CompiledTables) -> None:
        entries, self._rules_by_target = _dedup_entries(tables)
        buckets: Dict[int, Dict[Tuple[int, int], int]] = {}
        for ifindex, mask_len, masked_ip, target in entries:
            b = buckets.setdefault(mask_len, {})
            b[(ifindex, masked_ip >> (128 - mask_len) if mask_len else 0)] = target
        # longest first (equal lengths cannot coexist after the dedup)
        self._probe = sorted(buckets.items(), key=lambda kv: -kv[0])

    def _lookup(self, ifindex: int, ip_int: int, cap: int) -> int:
        for mask_len, bucket in self._probe:
            if mask_len + 32 > cap:
                continue  # entry longer than the packet-side key cap
            t = bucket.get((ifindex, ip_int >> (128 - mask_len) if mask_len else 0))
            if t is not None:
                return t
        return -1

    def classify(self, batch: PacketBatch) -> ClassifyResult:
        return _classify_with_lookup(self._lookup, self._rules_by_target, batch)


def _classify_with_lookup(lookup, rules_by_target, batch: PacketBatch) -> ClassifyResult:
    """The per-packet dispatch of kernel.c:412-457 around ``lookup(ifindex,
    ip_int, cap_prefix_len) -> target or -1``."""
    b = len(batch)
    results = np.zeros(b, np.uint32)
    xdp = np.zeros(b, np.int32)
    stats: Dict[int, List[int]] = {}

    for i in range(b):
        kind = int(batch.kind[i])
        if kind == KIND_MALFORMED:
            xdp[i] = XDP_DROP  # kernel.c:423-426
            continue
        if kind == KIND_OTHER:
            xdp[i] = XDP_PASS  # kernel.c:436-438
            continue
        is_v4 = kind == KIND_IPV4
        if not int(batch.l4_ok[i]):
            result = UNDEF  # extract failure -> SET_ACTION(UNDEF), kernel.c:199-202
        else:
            ip_int = 0
            for w in range(4):
                ip_int = (ip_int << 32) | int(batch.ip_words[i, w])
            cap = V4_KEY_PREFIX_LEN if is_v4 else V6_KEY_PREFIX_LEN
            target = lookup(int(batch.ifindex[i]), ip_int, cap)
            if target < 0:
                result = UNDEF
            else:
                result = _scan_rules(
                    rules_by_target[target],
                    int(batch.proto[i]),
                    int(batch.dst_port[i]),
                    int(batch.icmp_type[i]),
                    int(batch.icmp_code[i]),
                    is_v4,
                )
        results[i] = result
        action = result & 0xFF
        rule_id = (result >> 8) & 0xFFFFFF
        if action == DENY:
            xdp[i] = XDP_DROP
            _bump(stats, rule_id, deny=True, length=int(batch.pkt_len[i]))
        elif action == ALLOW:
            xdp[i] = XDP_PASS
            _bump(stats, rule_id, deny=False, length=int(batch.pkt_len[i]))
        else:
            xdp[i] = XDP_PASS  # UNDEF -> default pass, no stats (kernel.c:453-455)
    return ClassifyResult(results=results, xdp=xdp, stats=stats)


def _bump(stats: Dict[int, List[int]], rule_id: int, deny: bool, length: int) -> None:
    # The stats map has MAX_TARGETS entries; larger ruleIds record nothing
    # (kernel.c:376-390).
    if rule_id >= MAX_TARGETS:
        return
    entry = stats.setdefault(rule_id, [0, 0, 0, 0])
    if deny:
        entry[2] += 1
        entry[3] += length
    else:
        entry[0] += 1
        entry[1] += length


# --- the payload tier's references -------------------------------------------
#
# Both are independent of the compiled DFA (kernels/acmatch.py): the naive
# substring scan and an Aho-Corasick automaton that walks its failure links at
# match time, so a construction bug in the DFA cannot be shared by them.


def payload_match_ref(patterns, pay, plen, prefix_len, pwords) -> np.ndarray:
    """Naive multi-pattern reference -> (B, pwords) uint32 bitmaps (pattern
    j -> bit j).  ``pay`` (B, L) uint8, ``plen`` (B,) valid byte counts,
    ``prefix_len`` the matched prefix length: pattern j is claimed for packet
    i iff an occurrence ends within the first min(plen[i], prefix_len, L)
    bytes (an occurrence crossing that boundary claims nothing)."""
    pay = np.asarray(pay, np.uint8)
    plen = np.asarray(plen).astype(np.int64)
    out = np.zeros((pay.shape[0], int(pwords)), np.uint32)
    pats = [bytes(p) for p in patterns]
    for i in range(pay.shape[0]):
        n = int(min(plen[i], prefix_len, pay.shape[1]))
        hay = pay[i, :max(n, 0)].tobytes()
        for j, p in enumerate(pats):
            if p in hay:
                out[i, j // 32] |= np.uint32(1 << (j % 32))
    return out


class HostAcAutomaton:
    """A small Aho-Corasick automaton (goto and failure links, the links
    walked at match time, nothing folded): the second reference."""

    def __init__(self, patterns) -> None:
        from collections import deque

        self.patterns = [bytes(p) for p in patterns]
        self.goto: List[dict] = [{}]
        self.out: List[set] = [set()]
        for j, p in enumerate(self.patterns):
            s = 0
            for ch in p:
                if ch not in self.goto[s]:
                    self.goto.append({})
                    self.out.append(set())
                    self.goto[s][ch] = len(self.goto) - 1
                s = self.goto[s][ch]
            self.out[s].add(j)
        self.fail = [0] * len(self.goto)
        q = deque(self.goto[0].values())
        while q:
            s = q.popleft()
            for ch, t in self.goto[s].items():
                f = self.fail[s]
                while f and ch not in self.goto[f]:
                    f = self.fail[f]
                cand = self.goto[f].get(ch, 0)
                self.fail[t] = cand if cand != t else 0
                q.append(t)

    def matches(self, data: bytes) -> set:
        """The indices of the patterns with an occurrence ending in ``data``."""
        found = set()
        s = 0
        for ch in data:
            while s and ch not in self.goto[s]:
                s = self.fail[s]
            s = self.goto[s].get(ch, 0)
            f = s
            while f:
                found |= self.out[f]
                f = self.fail[f]
        return found
