"""Rule compiler: declarative firewall specs -> the dense rule tables.

The analogue of the reference's map writer
(pkg/ebpf/ingress_node_firewall_loader.go), for the dense path only:

- ``encode_rules``     mirrors makeIngressFwRulesMap's rule packing
  (loader.go:429-515): rule at array index == order, ruleId == order,
  single port encoded as dstPortEnd==0.
- ``build_key``        mirrors BuildEBPFKey (loader.go:530-547): the LPM key
  is (prefixLen = masklen + 32, ifindex, unmasked 16-byte address data).
- ``build_table_content`` mirrors the ebpfKeyToRules construction
  (loader.go:139-173), including the skip of invalid interfaces and
  bond-member expansion.
- ``compile_tables``   replaces Map.Update with array building: the
  160-bit LPM key/mask words per entry plus the (T, R, 7) int32 rule
  decision matrix mirroring ruleType_st (bpf/ingress_node_firewall.h:69-77).

Rule row columns: [ruleId, protocol, dstPortStart, dstPortEnd, icmpType,
icmpCode, action] — all int32.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from . import portutils
from .constants import (
    ALLOW,
    DENY,
    IPPROTO_ICMP,
    IPPROTO_ICMPV6,
    IPPROTO_SCTP,
    IPPROTO_TCP,
    IPPROTO_UDP,
    MAX_RULES_PER_TARGET,
)
from .interfaces import InterfaceRegistry
from .netutil import CIDRParseError, key_prefix_len, parse_cidr
from .spec import (
    ACTION_ALLOW,
    ACTION_DENY,
    PROTOCOL_TYPE_ICMP,
    PROTOCOL_TYPE_ICMP6,
    PROTOCOL_TYPE_SCTP,
    PROTOCOL_TYPE_TCP,
    PROTOCOL_TYPE_UDP,
    PROTOCOL_TYPE_UNSET,
    IngressNodeFirewallRules,
)

RULE_COLS = 7
COL_RULE_ID = 0
COL_PROTOCOL = 1
COL_PORT_START = 2
COL_PORT_END = 3
COL_ICMP_TYPE = 4
COL_ICMP_CODE = 5
COL_ACTION = 6

MAX_IFINDEX = 1 << 20


class CompileError(ValueError):
    pass


class LpmKey(NamedTuple):
    """BpfLpmIpKeySt equivalent (bpf/ingress_node_firewall.h:83-87).

    ``ip_data`` carries the *unmasked* address bytes exactly like the
    reference key (loader.go:537-541); masking happens at insert time.
    """

    prefix_len: int
    ingress_ifindex: int
    ip_data: bytes  # 16 bytes

    @property
    def mask_len(self) -> int:
        return self.prefix_len - 32

    def masked_identity(self) -> Tuple[int, int, bytes]:
        """The bits the LPM trie keys on: (prefixLen, ifindex, ip_data
        masked to mask_len bits).  Two keys with equal masked identity
        address the same entry, so a later insert replaces the earlier one
        (kernel lpm_trie semantics)."""
        m = self.mask_len
        full, rem = divmod(m, 8)
        data = bytearray(self.ip_data[:full]) + bytearray(16 - full)
        if rem:
            data[full] = self.ip_data[full] & ((0xFF00 >> rem) & 0xFF)
        return (self.prefix_len, self.ingress_ifindex, bytes(data))


def encode_rules(
    ingress: IngressNodeFirewallRules, width: int = MAX_RULES_PER_TARGET
) -> np.ndarray:
    """CRD protocol rules -> (width, 7) int32 row matrix.

    Mirrors loader.go:434-515: the row index is the rule's ``order`` and
    ruleId == order; index 0 stays zeroed.  Orders outside [1, width) are a
    compile error (the reference would panic on the array store)."""
    rules = np.zeros((width, RULE_COLS), dtype=np.int32)
    for rule in ingress.rules:
        idx = rule.order
        if idx < 1 or idx >= width:
            raise CompileError(
                f"rule order {idx} out of range [1, {width})"
            )
        rules[idx, COL_RULE_ID] = idx
        pc = rule.protocol_config
        proto = pc.protocol
        if proto in (PROTOCOL_TYPE_TCP, PROTOCOL_TYPE_UDP, PROTOCOL_TYPE_SCTP):
            pr = {PROTOCOL_TYPE_TCP: pc.tcp, PROTOCOL_TYPE_UDP: pc.udp,
                  PROTOCOL_TYPE_SCTP: pc.sctp}[proto]
            if pr is None:
                raise CompileError(f"missing port config for protocol {proto}")
            try:
                if portutils.is_range(pr):
                    start, end = portutils.get_range(pr)
                    rules[idx, COL_PORT_START] = start
                    rules[idx, COL_PORT_END] = end
                else:
                    rules[idx, COL_PORT_START] = portutils.get_port(pr)
                    rules[idx, COL_PORT_END] = 0
            except portutils.PortParseError as e:
                raise CompileError(f"invalid Port {pr.ports!r} for protocol {proto}: {e}")
            rules[idx, COL_PROTOCOL] = {
                PROTOCOL_TYPE_TCP: IPPROTO_TCP,
                PROTOCOL_TYPE_UDP: IPPROTO_UDP,
                PROTOCOL_TYPE_SCTP: IPPROTO_SCTP,
            }[proto]
        elif proto == PROTOCOL_TYPE_ICMP:
            if pc.icmp is None:
                raise CompileError("missing ICMP config")
            rules[idx, COL_ICMP_TYPE] = pc.icmp.icmp_type
            rules[idx, COL_ICMP_CODE] = pc.icmp.icmp_code
            rules[idx, COL_PROTOCOL] = IPPROTO_ICMP
        elif proto == PROTOCOL_TYPE_ICMP6:
            if pc.icmpv6 is None:
                raise CompileError("missing ICMPv6 config")
            rules[idx, COL_ICMP_TYPE] = pc.icmpv6.icmp_type
            rules[idx, COL_ICMP_CODE] = pc.icmpv6.icmp_code
            rules[idx, COL_PROTOCOL] = IPPROTO_ICMPV6
        elif proto != PROTOCOL_TYPE_UNSET:
            # Only the literal "" discriminator means the protocol-0
            # catch-all; a misspelled value must not become a catch-all.
            raise CompileError(f"unknown protocol {proto!r}")

        if rule.action == ACTION_ALLOW:
            rules[idx, COL_ACTION] = ALLOW
        elif rule.action == ACTION_DENY:
            rules[idx, COL_ACTION] = DENY
        else:
            raise CompileError(f"Failed invalid action {rule.action!r}")
    return rules


def build_key(if_id: int, cidr: str) -> LpmKey:
    """BuildEBPFKey (loader.go:530-547)."""
    try:
        parsed = parse_cidr(cidr)
    except CIDRParseError as e:
        raise CompileError(f"Failed to parse SourceCIDRs: {e}")
    return LpmKey(
        prefix_len=key_prefix_len(parsed.mask_len),
        ingress_ifindex=if_id,
        ip_data=parsed.ip_data,
    )


def build_table_content(
    iface_ingress_rules: Dict[str, List[IngressNodeFirewallRules]],
    registry: InterfaceRegistry,
    width: int = MAX_RULES_PER_TARGET,
) -> Dict[LpmKey, np.ndarray]:
    """The ebpfKeyToRules map (loader.go:139-173): desired LPM table
    content keyed by the full (unmasked) key.  Invalid interfaces are
    skipped with no error; unknown interfaces raise (loader.go:149-152)."""
    content: Dict[LpmKey, np.ndarray] = {}
    for iface_name, ingress_rules in iface_ingress_rules.items():
        if not registry.is_valid_interface_name_and_state(iface_name):
            continue
        if_ids = registry.get_interface_indices(iface_name)
        for ingress in ingress_rules:
            for if_id in if_ids:
                rules = encode_rules(ingress, width)
                for cidr in ingress.source_cidrs:
                    content[build_key(if_id, cidr)] = rules
    return content


def min_rule_width(
    iface_ingress_rules: Dict[str, List[IngressNodeFirewallRules]]
) -> int:
    """Smallest rule-matrix width that still places every rule at index ==
    order (shrinks the (T, R, 7) tensor below the full 100)."""
    max_order = 0
    for ingress_rules in iface_ingress_rules.values():
        for ingress in ingress_rules:
            for rule in ingress.rules:
                max_order = max(max_order, rule.order)
    return max(2, max_order + 1)


@dataclass
class CompiledTables:
    """Classifier state compiled from one desired ruleset (dense form).

      key_words:  (T, 5) uint32 — [ifindex, ip word0..3] big-endian words of
                  the masked 160-bit LPM key,
      mask_words: (T, 5) uint32 — 160-bit mask (ifindex word always ~0),
      mask_len:   (T,)  int32   — CIDR mask length (without ifindex bits),
                  -1 marks a tombstoned row that never matches,
      rules:      (T, R, 7) int32 rule decision matrix,
      content:    the deduplicated {LpmKey: rules} map the arrays were
                  built from (the oracle's input).

    An empty table keeps one zeroed padding row (num_entries == 0).
    """

    rule_width: int
    num_entries: int
    key_words: np.ndarray
    mask_words: np.ndarray
    mask_len: np.ndarray
    rules: np.ndarray
    content: Dict[LpmKey, np.ndarray] = field(default_factory=dict)


def _mask_words_vec(mask_len: np.ndarray) -> np.ndarray:
    """(T,) mask lengths -> (T, 4) uint32 IP mask words."""
    w = np.arange(4)[None, :]
    bits = np.clip(mask_len[:, None] - 32 * w, 0, 32).astype(np.uint64)
    full = np.uint64(0xFFFFFFFF)
    return ((full << (np.uint64(32) - bits)) & full * (bits > 0)).astype(np.uint32)


def _validate_key(key: LpmKey) -> None:
    if key.ingress_ifindex < 0 or key.ingress_ifindex > MAX_IFINDEX:
        raise CompileError(f"ifindex {key.ingress_ifindex} out of supported range")
    if not (32 <= key.prefix_len <= 160):
        raise CompileError(f"prefixLen {key.prefix_len} out of range [32,160]")
    if len(key.ip_data) != 16:
        raise CompileError(
            f"ip_data must be exactly 16 bytes, got {len(key.ip_data)}"
        )


def compile_tables_from_content(
    content: Dict[LpmKey, np.ndarray],
    rule_width: int = MAX_RULES_PER_TARGET,
) -> CompiledTables:
    """Build the arrays from explicit LPM-map content (also how tests drive
    adversarial tables directly).  Keys with equal masked identity collapse
    as successive Map.Update calls do: the entry keeps the position of the
    first occurrence and the value (and key) of the last writer."""
    dedup: Dict[Tuple[int, int, bytes], Tuple[LpmKey, np.ndarray, bytes]] = {}
    for key, rows in content.items():
        _validate_key(key)
        ident = key.masked_identity()
        dedup[ident] = (key, rows, ident[2])
    entries = list(dedup.values())
    T = len(entries)
    R = rule_width
    n = max(T, 1)  # an empty table keeps one zeroed padding row

    key_words = np.zeros((n, 5), np.uint32)
    mask_words = np.zeros((n, 5), np.uint32)
    mask_len = np.zeros(n, np.int32)
    rules = np.zeros((n, R, RULE_COLS), np.int32)
    if T:
        ml = np.fromiter((k.mask_len for k, _r, _m in entries), np.int64, count=T)
        masked = np.frombuffer(b"".join(m for _k, _r, m in entries), np.uint8)
        key_words[:T, 0] = np.fromiter(
            (k.ingress_ifindex for k, _r, _m in entries), np.int64, count=T
        )
        key_words[:T, 1:] = masked.reshape(T, 16).view(">u4").astype(np.uint32)
        mask_words[:T, 0] = 0xFFFFFFFF
        mask_words[:T, 1:] = _mask_words_vec(ml)
        mask_len[:T] = ml
        for t, (_k, rows, _m) in enumerate(entries):
            rows = np.asarray(rows, np.int32)
            rules[t, : min(rows.shape[0], R)] = rows[:R]
    return CompiledTables(
        rule_width=R,
        num_entries=T,
        key_words=key_words,
        mask_words=mask_words,
        mask_len=mask_len,
        rules=rules,
        content={k: r for k, r, _m in entries},
    )


def compile_tables(
    iface_ingress_rules: Dict[str, List[IngressNodeFirewallRules]],
    registry: InterfaceRegistry,
    rule_width: Optional[int] = None,
) -> CompiledTables:
    """Full compile: desired interface rules -> CompiledTables."""
    if rule_width is None:
        rule_width = min_rule_width(iface_ingress_rules)
    rule_width = min(max(rule_width, 2), MAX_RULES_PER_TARGET)
    content = build_table_content(iface_ingress_rules, registry, rule_width)
    return compile_tables_from_content(content, rule_width=rule_width)
