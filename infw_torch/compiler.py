"""Rule compiler: declarative firewall specs -> the dense and trie tables.

The analogue of the reference's map writer
(pkg/ebpf/ingress_node_firewall_loader.go):

- ``encode_rules``     mirrors makeIngressFwRulesMap's rule packing
  (loader.go:429-515): rule at array index == order, ruleId == order,
  single port encoded as dstPortEnd==0.
- ``build_key``        mirrors BuildEBPFKey (loader.go:530-547): the LPM key
  is (prefixLen = masklen + 32, ifindex, unmasked 16-byte address data).
- ``build_table_content`` mirrors the ebpfKeyToRules construction
  (loader.go:139-173), including the skip of invalid interfaces and
  bond-member expansion.
- ``compile_tables``   replaces Map.Update with array building: the
  160-bit LPM key/mask words per entry, the (T, R, 7) int32 rule
  decision matrix mirroring ruleType_st (bpf/ingress_node_firewall.h:69-77),
  and the variable-stride leaf-pushed trie (``VarTrie``) the trie path
  walks.  The build is columnar (``TableColumns``): masked-identity dedup
  is one lexsort and the trie is built level by level with NumPy batch
  operations, so a 100K-entry table has no per-key Python loop.

Rule row columns: [ruleId, protocol, dstPortStart, dstPortEnd, icmpType,
icmpCode, action] — all int32.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from collections.abc import MutableMapping
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

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


# --- columnar content ------------------------------------------------------


@dataclass
class TableColumns:
    """Columnar LPM-map content, the input of the vectorized build:

      prefix_len: (T,) int32      — mask_len + 32 (LpmKey.prefix_len)
      ifindex:    (T,) int64
      ip:         (T, 16) uint8   — unmasked address bytes (LpmKey.ip_data)
      rules:      (T, W, 7) int32 — packed rule rows
    """

    prefix_len: np.ndarray
    ifindex: np.ndarray
    ip: np.ndarray
    rules: np.ndarray

    def __len__(self) -> int:
        return int(self.prefix_len.shape[0])

    @property
    def mask_len(self) -> np.ndarray:
        return self.prefix_len.astype(np.int64) - 32


def columns_from_content(
    content: Mapping[LpmKey, np.ndarray], rule_width: Optional[int] = None
) -> TableColumns:
    """Dict content -> TableColumns.  The per-key iteration here is
    C-level (fromiter / bytes join / stack); everything downstream is
    vectorized.  Ragged rule widths pad to the widest.  An untouched
    LazyContent hands over its columns as they are."""
    if isinstance(content, LazyContent):
        cols = content.columns()
        if cols is not None:
            return cols
    T = len(content)
    plen = np.fromiter((k.prefix_len for k in content), np.int32, count=T)
    ifx = np.fromiter((k.ingress_ifindex for k in content), np.int64, count=T)
    lens = np.fromiter((len(k.ip_data) for k in content), np.int64, count=T)
    if (lens != 16).any():
        # per key, not in aggregate: a 15- and a 17-byte key keep the total
        # at 16*T but would misalign every later key's bytes
        raise CompileError(f"ip_data must be exactly 16 bytes, got {int(lens[lens != 16][0])}")
    ip = (
        np.frombuffer(b"".join(k.ip_data for k in content), np.uint8).reshape(T, 16)
        if T else np.zeros((0, 16), np.uint8)
    )
    vals = [np.asarray(v, np.int32) for v in content.values()]
    if T and all(v.shape == vals[0].shape for v in vals) and vals[0].ndim == 2:
        rules = np.stack(vals)
    else:
        W = max((v.shape[0] for v in vals), default=rule_width or 2)
        rules = np.zeros((T, W, RULE_COLS), np.int32)
        for i, v in enumerate(vals):
            rules[i, : v.shape[0]] = v
    return TableColumns(prefix_len=plen, ifindex=ifx, ip=ip, rules=rules)


#: (129, 16) per-byte mask rows for every legal mask length
_BYTE_MASK_LUT = (
    (0xFF00 >> np.clip(np.arange(129)[:, None] - 8 * np.arange(16)[None, :], 0, 8)) & 0xFF
).astype(np.uint8)


def mask_ip_bytes(ip: np.ndarray, mask_len: np.ndarray) -> np.ndarray:
    """Vectorized LpmKey.masked_identity address masking: (T, 16) uint8
    unmasked bytes + (T,) mask lengths -> masked bytes."""
    return ip & _BYTE_MASK_LUT[np.clip(np.asarray(mask_len, np.int64), 0, 128)]


def _validate_columns(cols: TableColumns) -> None:
    """Key validation over a whole column set (first offender reported)."""
    ifx = np.asarray(cols.ifindex, np.int64)
    bad = (ifx < 0) | (ifx > MAX_IFINDEX)
    if bad.any():
        raise CompileError(f"ifindex {int(ifx[bad][0])} out of supported range")
    plen = np.asarray(cols.prefix_len, np.int64)
    bad = (plen < 32) | (plen > 160)
    if bad.any():
        raise CompileError(f"prefixLen {int(plen[bad][0])} out of range [32,160]")
    if cols.ip.shape[1:] != (16,):
        raise CompileError(f"ip columns must be (T, 16) uint8, got {cols.ip.shape}")


def _dedup_columns(cols: TableColumns) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Masked-identity dedup as one lexsort: returns (win, masked_ip,
    trie_order).  ``win[j]`` is the source row of the j-th surviving entry;
    survivors keep the order of each identity's first occurrence and the
    value of its last writer (the dict semantics of successive Map.Update
    calls).  ``trie_order`` permutes the survivors into ascending
    (ifindex, masked address) order, the radix order the trie's bulk
    build needs (the identity sort already produced it)."""
    T = len(cols)
    masked = mask_ip_bytes(cols.ip, cols.mask_len)
    if T == 0:
        z = np.zeros(0, np.int64)
        return z, masked, z
    k0 = np.asarray(cols.ifindex, np.int64)
    mc = np.ascontiguousarray(masked)
    k1 = mc[:, :8].reshape(T, 8).view(">u8")[:, 0]
    k2 = mc[:, 8:].reshape(T, 8).view(">u8")[:, 0]
    kp = np.asarray(cols.prefix_len, np.int64)
    # (ifindex, address) first so group order doubles as the radix order;
    # prefix_len only separates identities.  lexsort is stable, so equal
    # identities keep input order.
    order = np.lexsort((kp, k2, k1, k0))
    s0, s1, s2, sp = k0[order], k1[order], k2[order], kp[order]
    new_group = np.empty(T, bool)
    new_group[0] = True
    new_group[1:] = (s0[1:] != s0[:-1]) | (s1[1:] != s1[:-1]) | (
        s2[1:] != s2[:-1]) | (sp[1:] != sp[:-1])
    starts = np.nonzero(new_group)[0]
    ends = np.append(starts[1:], T)
    first_idx = order[starts]  # first occurrence: the entry's position
    last_idx = order[ends - 1]  # last writer: the entry's value
    perm = np.argsort(first_idx, kind="stable")
    inv = np.empty(len(perm), np.int64)
    inv[perm] = np.arange(len(perm))
    return last_idx[perm], masked, inv


class LazyContent(MutableMapping):
    """The {LpmKey: rules} content map, built from its columns on first
    access (a cold build at the 10M tier spends most of its time making
    the key tuples, which the serving path never reads).  ``columns()``
    returns the columns without building the map, and None once it is
    built (a mutation may have left the columns stale)."""

    def __init__(self, plen, ifx, ip, rules):
        self._cols = (plen, ifx, ip, rules)
        self._d: Optional[Dict[LpmKey, np.ndarray]] = None

    def columns(self) -> Optional[TableColumns]:
        if self._d is not None:
            return None
        plen, ifx, ip, rules = self._cols
        return TableColumns(prefix_len=np.asarray(plen, np.int32),
                            ifindex=np.asarray(ifx, np.int64), ip=ip, rules=rules)

    def _ensure(self) -> Dict[LpmKey, np.ndarray]:
        if self._d is None:
            plen, ifx, ip, rules = self._cols
            ip_b = np.ascontiguousarray(ip, np.uint8).tobytes()
            self._d = {
                LpmKey(int(plen[t]), int(ifx[t]), ip_b[16 * t : 16 * t + 16]): rules[t]
                for t in range(len(plen))
            }
        return self._d

    def __getitem__(self, k):
        return self._ensure()[k]

    def __setitem__(self, k, v):
        self._ensure()[k] = v

    def __delitem__(self, k):
        del self._ensure()[k]

    def __iter__(self):
        return iter(self._ensure())

    def __len__(self):
        return len(self._cols[0]) if self._d is None else len(self._d)


# --- the trie ---------------------------------------------------------------

# Variable-stride trie scheme: a 16-bit direct-indexed root level followed
# by 8-bit levels (DIR-16-8).  Level bit boundaries are 16, 24, 32, ... so
# the IPv4 packet-side cap (32 bits) always falls on a level boundary, and
# the level count follows the longest prefix present: a table with nothing
# longer than /64 compiles to 7 levels, not 15.
VAR_TRIE_ROOT_STRIDE = 16
VAR_TRIE_STRIDE = 8


def trie_level_strides(n_levels: int) -> List[int]:
    return [VAR_TRIE_ROOT_STRIDE] + [VAR_TRIE_STRIDE] * (n_levels - 1)


def trie_levels_for_mask(max_mask_len: int) -> int:
    if max_mask_len <= VAR_TRIE_ROOT_STRIDE:
        return 1
    return 1 + -(-(max_mask_len - VAR_TRIE_ROOT_STRIDE) // VAR_TRIE_STRIDE)


class VarTrie:
    """Leaf-pushed variable-stride trie (16-bit root level + 8-bit levels)
    with NumPy batch inserts.

    Node 0 of every level is the null node; one level-0 root per ifindex.
    Level l packs [child node in level l+1 (0 = none), target + 1 (0 =
    none)] per slot.  Each slot holds the longest prefix that covers it;
    equal lengths resolve to the highest insertion sequence (last writer
    wins).  Node numbering follows (parent, slot) order level by level,
    which is the numbering the JAX package's builds give.

    A one-shot build (``incremental=False``, what compile_tables does)
    inserts once into the empty trie and keeps no slot priorities.  An
    incremental trie (IncrementalTables) keeps the per-slot priority
    ``(mask_len + 1) << 40 | seq`` beside the slots, so later inserts
    compare against what a slot holds and ``repush_node`` re-resolves one
    node after a delete; ``mutations`` stamps every slot write and
    dirty-row tracking records the slot rows written since it (re)started.
    """

    def __init__(self, n_levels: int, incremental: bool = False):
        self.n_levels = max(1, n_levels)
        self.strides = trie_level_strides(self.n_levels)
        self.bit_ends = np.cumsum(self.strides).astype(np.int64)
        # flat per-level slot arrays, capacity-grown: n_cap * slots rows
        self._ct: List[np.ndarray] = [
            np.zeros((2 << s, 2), np.int32) for s in self.strides
        ]
        #: per-slot priorities (0 = empty slot); None on a one-shot build
        self._prio: Optional[List[np.ndarray]] = (
            [np.zeros(2 << s, np.int64) for s in self.strides] if incremental else None
        )
        #: per level: no slot has held a priority yet (no compare needed)
        self._virgin: List[bool] = [True] * self.n_levels
        self.n_nodes: List[int] = [1] * self.n_levels  # incl. null node 0
        self.roots: Dict[int, int] = {}
        self.mutations = 0
        #: per level, the slot rows written since tracking (re)started;
        #: None = tracking off
        self._dirty_rows: Optional[List[List[np.ndarray]]] = None
        self._levels_cache = None  # (mutations, level copies) of arrays()

    def start_dirty_tracking(self) -> None:
        self._dirty_rows = [[] for _ in range(self.n_levels)]

    def _record_rows(self, level: int, rows: np.ndarray) -> None:
        if self._dirty_rows is not None:
            self._dirty_rows[level].append(np.asarray(rows, np.int64))

    def drain_dirty(self) -> Optional[List[np.ndarray]]:
        """Per-level unique slot rows written since tracking (re)started (a
        superset of the rows whose values changed), or None when tracking
        is off.  Does not clear: start_dirty_tracking does, once the
        consumer has applied them."""
        if self._dirty_rows is None:
            return None
        return [
            np.unique(np.concatenate(parts)) if parts else np.zeros(0, np.int64)
            for parts in self._dirty_rows
        ]

    def _slots(self, level: int) -> int:
        return 1 << self.strides[level]

    def _alloc_nodes(self, level: int, count: int) -> int:
        """Allocate ``count`` fresh zeroed nodes; return the first id."""
        self.mutations += 1
        first = self.n_nodes[level]
        need = (first + count) * self._slots(level)
        cur = self._ct[level].shape[0]
        if need > cur:
            cap = max(need, 2 * cur)
            ct = np.zeros((cap, 2), np.int32)
            ct[:cur] = self._ct[level]
            self._ct[level] = ct
            if self._prio is not None:
                prio = np.zeros(cap, np.int64)
                prio[:cur] = self._prio[level]
                self._prio[level] = prio
        self.n_nodes[level] += count
        return first

    def _root_for_vec(self, ifindex: np.ndarray) -> np.ndarray:
        """Level-0 root of each ifindex, allocated on demand in ascending
        ifindex order."""
        uniq, inv = np.unique(ifindex, return_inverse=True)
        ids = np.empty(len(uniq), np.int64)
        for i, ifx in enumerate(uniq):
            node = self.roots.get(int(ifx))
            if node is None:
                node = self._alloc_nodes(0, 1)
                self.roots[int(ifx)] = node
            ids[i] = node
        return ids[inv]

    @staticmethod
    def _level_slot(ip: np.ndarray, level: int) -> np.ndarray:
        """Slot of each entry at ``level`` from (E, 16) big-endian address
        bytes: the root consumes bytes 0..1, level l >= 1 byte l + 1."""
        if level == 0:
            return ip[:, 0].astype(np.int64) << 8 | ip[:, 1]
        return ip[:, level + 1].astype(np.int64)

    def term_levels(self, mask_len: np.ndarray) -> np.ndarray:
        """Level each prefix terminates (and leaf-pushes) at."""
        return np.searchsorted(self.bit_ends, mask_len, side="left")

    def batch_insert(
        self, ifindex: np.ndarray, ip: np.ndarray, mask_len: np.ndarray,
        target: np.ndarray, seq: np.ndarray, sort_hint: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Insert E prefixes (masked address bytes); returns (term_level,
        term_node) per entry, int32.  Into an empty trie with ``sort_hint``
        (the (ifindex, address) ascending permutation, ``_dedup_columns``'s
        ``trie_order``) one pass of neighbor compares per level allocates
        the child nodes; otherwise each level allocates the missing
        children of its sorted unique slot codes.  Both number nodes in
        (parent, slot) order."""
        mask_len = np.asarray(mask_len, np.int64)
        if len(target) == 0:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        if int(mask_len.max()) > int(self.bit_ends[-1]):
            raise CompileError(
                f"mask_len {int(mask_len.max())} exceeds trie depth "
                f"({self.n_levels} levels, {int(self.bit_ends[-1])} bits)"
            )
        t_level = self.term_levels(mask_len)
        empty = not self.roots and all(n == 1 for n in self.n_nodes)
        if empty and sort_hint is not None:
            term_node = self._build_children(np.asarray(ifindex, np.int64), ip, t_level,
                                             sort_hint)
            tl_s = t_level[sort_hint]
            for l in np.unique(t_level):
                sel = sort_hint[tl_s == l]
                self._leaf_push(int(l), term_node[sel], ip[sel], mask_len[sel],
                                target[sel], seq[sel])
        else:
            term_node = self._insert_children(np.asarray(ifindex, np.int64), ip, t_level)
            for l in np.unique(t_level):
                m = t_level == l
                self._leaf_push(int(l), term_node[m], ip[m], mask_len[m], target[m], seq[m])
        return t_level.astype(np.int32), term_node.astype(np.int32)

    def _insert_children(self, ifindex: np.ndarray, ip: np.ndarray,
                         t_level: np.ndarray) -> np.ndarray:
        """Child construction into a trie that may hold entries: each level
        allocates the children its entries miss, in sorted slot-code order.
        Returns each entry's terminal node."""
        parent = self._root_for_vec(ifindex)
        term_node = np.where(t_level == 0, parent, 0)
        for l in range(1, self.n_levels):
            reach = t_level >= l
            if not reach.any():
                break
            code = parent[reach] * self._slots(l - 1) + self._level_slot(ip[reach], l - 1)
            existing = self._ct[l - 1][code, 0]
            need = existing == 0
            if need.any():
                uniq_codes = np.unique(code[need])
                first = self._alloc_nodes(l, len(uniq_codes))
                self._ct[l - 1][uniq_codes, 0] = first + np.arange(len(uniq_codes), dtype=np.int32)
                self._record_rows(l - 1, uniq_codes)
                existing = self._ct[l - 1][code, 0]
            parent[reach] = existing
            term_node = np.where(t_level == l, parent, term_node)
        return term_node

    def _build_children(
        self, ifindex: np.ndarray, ip: np.ndarray, t_level: np.ndarray,
        osort: np.ndarray,
    ) -> np.ndarray:
        """Child construction over the radix-ordered entries ``osort`` of
        an empty trie: roots in ascending ifindex order, then each level's
        node allocation is a neighbor compare + cumsum over the sorted
        codes.  Returns each entry's terminal node, in input order."""
        E = len(ifindex)
        ifx_s = ifindex[osort]
        ip_s = np.ascontiguousarray(ip)[osort]
        tlv_s = t_level[osort]

        new_if = np.empty(E, bool)
        new_if[0] = True
        new_if[1:] = ifx_s[1:] != ifx_s[:-1]
        uniq_if = ifx_s[new_if]
        first_root = self._alloc_nodes(0, len(uniq_if))
        for i, ifx in enumerate(uniq_if):
            self.roots[int(ifx)] = first_root + i
        parent_s = first_root + np.cumsum(new_if) - 1
        term_s = np.where(tlv_s == 0, parent_s, 0)

        slot_col0 = (ip_s[:, 0].astype(np.int64) << 8) | ip_s[:, 1]
        # the entries still descending at level l, kept in radix order
        active = np.nonzero(tlv_s >= 1)[0]
        par = parent_s[active]
        tlv_a = tlv_s[active]
        for l in range(1, self.n_levels):
            if not len(active):
                break
            slot = slot_col0[active] if l == 1 else ip_s[active, l].astype(np.int64)
            code = par * self._slots(l - 1) + slot
            is_first = np.empty(len(code), bool)
            is_first[0] = True
            is_first[1:] = code[1:] != code[:-1]
            n_new = int(is_first.sum())
            first = self._alloc_nodes(l, n_new)
            self._ct[l - 1][code[is_first], 0] = first + np.arange(n_new, dtype=np.int32)
            self._record_rows(l - 1, code[is_first])
            child = first + np.cumsum(is_first) - 1
            done = tlv_a == l
            term_s[active[done]] = child[done]
            keep = ~done
            active, par, tlv_a = active[keep], child[keep], tlv_a[keep]

        term_node = np.empty(E, np.int64)
        term_node[osort] = term_s
        return term_node

    def _leaf_push(
        self, level: int, node: np.ndarray, ip: np.ndarray, mask_len: np.ndarray,
        target: np.ndarray, seq: np.ndarray,
    ) -> None:
        """Slot expansion + per-slot winner for entries that all terminate
        at ``level``: each slot takes the entry of highest priority
        (mask_len + 1, seq), and on an incremental trie replaces what the
        slot holds when its priority is at least the resident one."""
        span = np.int64(1) << (self.bit_ends[level] - mask_len)
        base = self._level_slot(ip, level) & ~(span - 1)
        total = int(span.sum())
        if total == 0:
            return
        self.mutations += 1
        rep = np.repeat(np.arange(len(span)), span)
        offs = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(span) - span, span)
        flat = node.astype(np.int64)[rep] * self._slots(level) + base[rep] + offs
        prio = ((mask_len.astype(np.int64) + 1) << 40) | seq.astype(np.int64)
        # sorted by (slot, priority), each slot's last element is its winner;
        # priorities are unique because seq is
        if int(flat.max()) < (1 << 31) and int(seq.max()) < (1 << 24):
            rank = ((mask_len.astype(np.int64) + 1) << 24) | seq.astype(np.int64)
            order = np.argsort((flat << 32) | rank[rep], kind="stable")
        else:
            order = np.lexsort((prio[rep], flat))
        of = flat[order]
        wi = order[np.nonzero(np.append(of[1:] != of[:-1], True))[0]]
        fw = flat[wi]
        if self._prio is not None:
            pw = prio[rep[wi]]
            if not self._virgin[level]:
                take = pw >= self._prio[level][fw]
                fw, wi, pw = fw[take], wi[take], pw[take]
            self._prio[level][fw] = pw
        self._virgin[level] = False
        self._ct[level][fw, 1] = (target.astype(np.int64) + 1)[rep[wi]].astype(np.int32)
        self._record_rows(level, fw)

    def repush_node(
        self, level: int, node: int, ip: np.ndarray, mask_len: np.ndarray,
        target: np.ndarray, seq: np.ndarray,
    ) -> None:
        """Clear one node's targets and re-resolve them from the surviving
        prefixes that terminate there (child links are untouched): the
        node-local delete of an incremental trie."""
        slots = self._slots(level)
        self.mutations += 1
        sl = slice(node * slots, (node + 1) * slots)
        self._ct[level][sl, 1] = 0
        self._prio[level][sl] = 0
        self._record_rows(level, np.arange(sl.start, sl.stop, dtype=np.int64))
        if len(target):
            self._leaf_push(level, np.full(len(target), node, np.int64), ip,
                            np.asarray(mask_len, np.int64), target, seq)

    def arrays(self, max_ifindex: int, consume: bool = True) -> Tuple[List[np.ndarray], np.ndarray]:
        """The device-layout level tables ((n_nodes_l * slots_l, 2) int32
        each) and the (max_ifindex + 1,) root LUT.  ``consume`` shrinks the
        growth buffers in place and hands them out (the trie is done after
        it); otherwise each level is copied, and the copies are reused
        until the next slot write (snapshots never mutate them)."""
        if consume:
            levels = []
            for l in range(self.n_levels):
                self._ct[l].resize((self.n_nodes[l] * self._slots(l), 2), refcheck=False)
                levels.append(self._ct[l])
        elif self._levels_cache is not None and self._levels_cache[0] == self.mutations:
            levels = list(self._levels_cache[1])
        else:
            levels = [self._ct[l][: self.n_nodes[l] * self._slots(l)].copy()
                      for l in range(self.n_levels)]
            self._levels_cache = (self.mutations, tuple(levels))
        root_lut = np.zeros(max_ifindex + 1, np.int32)
        for ifindex, node in self.roots.items():
            root_lut[ifindex] = node
        return levels, root_lut


# --- compiled tensors -------------------------------------------------------


@dataclass
class CompiledTables:
    """Classifier state compiled from one desired ruleset.

    Dense LPM representation (the compare-all kernel):
      key_words:  (T, 5) uint32 — [ifindex, ip word0..3] big-endian words of
                  the masked 160-bit LPM key,
      mask_words: (T, 5) uint32 — 160-bit mask (ifindex word always ~0),
      mask_len:   (T,)  int32   — CIDR mask length (without ifindex bits),
                  -1 marks a tombstoned row that never matches.

    Trie representation (the walk at 100K+ entries), see VarTrie:
      trie_levels: per level (n_nodes_l * slots_l, 2) int32 — per slot
                   [child node in level l+1 (0 = none), target + 1 (0 =
                   none)]; node 0 of every level is the null node,
      root_lut:    (max_ifindex + 1,) int32 — ifindex -> level-0 node.

    Shared:
      rules:   (T, R, 7) int32 rule decision matrix,
      content: the deduplicated {LpmKey: rules} map the arrays were built
               from (the oracle's input).

    An empty table keeps one zeroed padding row (num_entries == 0).  Host
    layouts derived from these arrays (``layout.py``) are memoized on the
    instance, which is never mutated.
    """

    rule_width: int
    num_entries: int
    key_words: np.ndarray
    mask_words: np.ndarray
    mask_len: np.ndarray
    rules: np.ndarray
    trie_levels: List[np.ndarray]
    root_lut: np.ndarray
    content: Dict[LpmKey, np.ndarray] = field(default_factory=dict)

    @property
    def levels(self) -> int:
        return len(self.trie_levels)

    def save(self, path) -> None:
        """Persist the tables (the daemon's checkpoint, the pinned-map
        equivalent) as the JAX package's npz layout, key for key: the
        content as packed columns and each trie level sparsely (the row
        index of its nonzero rows, those rows, its shape).  ``path`` is a
        filename or a writable binary file."""
        meta = {
            "rule_width": self.rule_width,
            "num_entries": self.num_entries,
            "n_trie_levels": len(self.trie_levels),
        }
        cols = columns_from_content(self.content, self.rule_width)
        content_rules = (
            np.asarray(cols.rules, np.int32) if len(cols)
            else np.zeros((0, self.rule_width, RULE_COLS), np.int32)
        )
        levels = {}
        for i, tbl in enumerate(self.trie_levels):
            nnz = np.nonzero(tbl.any(axis=tuple(range(1, tbl.ndim))))[0]
            levels[f"trie_level_{i}_nnz"] = nnz.astype(np.int64)
            levels[f"trie_level_{i}_rows"] = tbl[nnz]
            levels[f"trie_level_{i}_shape"] = np.asarray(tbl.shape, np.int64)
        np.savez_compressed(
            path,
            meta=json.dumps(meta),
            key_words=self.key_words,
            mask_words=self.mask_words,
            mask_len=self.mask_len,
            rules=self.rules,
            root_lut=self.root_lut,
            content_rules=content_rules,
            content_key_plen=np.asarray(cols.prefix_len, np.uint16),
            content_key_ifx=np.asarray(cols.ifindex, np.uint32),
            content_key_ip=cols.ip,
            **levels,
        )

    @classmethod
    def load(cls, path) -> "CompiledTables":
        """Read a checkpoint written by ``save`` or by the JAX package's
        CompiledTables.save; the content comes back as a LazyContent over
        the stored columns."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            if "n_trie_levels" not in meta or "content_key_plen" not in z:
                raise CompileError(
                    f"{path}: incompatible compiled-table format; recompile from the spec"
                )
            content = LazyContent(
                z["content_key_plen"].astype(np.int64),
                z["content_key_ifx"].astype(np.int64),
                z["content_key_ip"],
                z["content_rules"],
            )
            trie_levels = []
            for i in range(meta["n_trie_levels"]):
                rows = z[f"trie_level_{i}_rows"]
                tbl = np.zeros(tuple(z[f"trie_level_{i}_shape"]), rows.dtype)
                tbl[z[f"trie_level_{i}_nnz"]] = rows
                trie_levels.append(tbl)
            return cls(
                rule_width=meta["rule_width"],
                num_entries=meta["num_entries"],
                key_words=z["key_words"],
                mask_words=z["mask_words"],
                mask_len=z["mask_len"],
                rules=z["rules"],
                trie_levels=trie_levels,
                root_lut=z["root_lut"],
                content=content,
            )


def _mask_words_vec(mask_len: np.ndarray) -> np.ndarray:
    """(T,) mask lengths -> (T, 4) uint32 IP mask words."""
    w = np.arange(4)[None, :]
    bits = np.clip(mask_len[:, None] - 32 * w, 0, 32).astype(np.uint64)
    full = np.uint64(0xFFFFFFFF)
    return ((full << (np.uint64(32) - bits)) & full * (bits > 0)).astype(np.uint32)


def _compile_columns(
    cols: TableColumns, rule_width: int, min_trie_levels: int
) -> Tuple[CompiledTables, np.ndarray]:
    """The one build: validate, dedup, pack the dense rows and build the
    trie.  Returns the tables (without content) and ``win``, the source
    row of each surviving entry."""
    _validate_columns(cols)
    win, masked, trie_order = _dedup_columns(cols)
    T = len(win)
    R = rule_width
    n = max(T, 1)  # an empty table keeps one zeroed padding row
    mask_len = cols.mask_len[win]
    ifindex = np.asarray(cols.ifindex, np.int64)[win]
    ip = np.ascontiguousarray(masked[win])  # dense rows and the trie: MASKED bytes

    key_words = np.zeros((n, 5), np.uint32)
    mask_words = np.zeros((n, 5), np.uint32)
    mask_len_col = np.zeros(n, np.int32)
    rules = np.zeros((n, R, RULE_COLS), np.int32)
    if T:
        key_words[:T, 0] = ifindex
        key_words[:T, 1:] = ip.view(">u4").astype(np.uint32)
        mask_words[:T, 0] = 0xFFFFFFFF
        mask_words[:T, 1:] = _mask_words_vec(mask_len)
        mask_len_col[:T] = mask_len
        w = min(cols.rules.shape[1], R)
        rules[:T, :w] = np.asarray(cols.rules, np.int32)[win, :w]

    max_mask = int(mask_len.max()) if T else 0
    trie = VarTrie(max(trie_levels_for_mask(max_mask), min_trie_levels))
    seq = np.arange(T, dtype=np.int64)
    trie.batch_insert(ifindex, ip, mask_len, seq, seq, sort_hint=trie_order)
    trie_levels, root_lut = trie.arrays(int(ifindex.max()) if T else 0)
    tables = CompiledTables(
        rule_width=R, num_entries=T, key_words=key_words, mask_words=mask_words,
        mask_len=mask_len_col, rules=rules, trie_levels=trie_levels, root_lut=root_lut,
    )
    return tables, win


def compile_tables_from_content(
    content: Mapping[LpmKey, np.ndarray],
    rule_width: int = MAX_RULES_PER_TARGET,
    min_trie_levels: int = 1,
) -> CompiledTables:
    """Build the tables from explicit LPM-map content (also how tests drive
    adversarial tables directly).  Keys with equal masked identity collapse
    as successive Map.Update calls do: the entry keeps the position of the
    first occurrence and the value (and key) of the last writer.
    ``min_trie_levels`` forces at least that many trie levels."""
    tables, win = _compile_columns(
        columns_from_content(content, rule_width), rule_width, min_trie_levels
    )
    keys, vals = list(content), list(content.values())
    tables.content = {keys[i]: vals[i] for i in win.tolist()}
    return tables


def compile_tables_from_columns(
    cols: TableColumns,
    rule_width: int = MAX_RULES_PER_TARGET,
    min_trie_levels: int = 1,
) -> CompiledTables:
    """The same build from columnar content; the {LpmKey: rules} map of the
    surviving entries is a LazyContent, built on first access (the oracle
    reads it, the device layouts never do)."""
    tables, win = _compile_columns(cols, rule_width, min_trie_levels)
    tables.content = LazyContent(
        np.asarray(cols.prefix_len, np.int32)[win], np.asarray(cols.ifindex, np.int64)[win],
        np.ascontiguousarray(np.asarray(cols.ip, np.uint8)[win]), np.asarray(cols.rules)[win],
    )
    return tables


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


def _validate_key(key: LpmKey) -> None:
    if key.ingress_ifindex < 0 or key.ingress_ifindex > MAX_IFINDEX:
        raise CompileError(f"ifindex {key.ingress_ifindex} out of supported range")
    if not (32 <= key.prefix_len <= 160):
        raise CompileError(f"prefixLen {key.prefix_len} out of range [32,160]")
    if len(key.ip_data) != 16:
        raise CompileError(f"ip_data must be exactly 16 bytes, got {len(key.ip_data)}")


# --- incremental tables -----------------------------------------------------


class IncrementalTables:
    """Mutable compiled-table state: a columnar full build plus per-key
    add, update and delete, the granularity of the reference's
    addOrUpdateRules / purgeKeys (loader.go:200-218,633), where a one-CIDR
    edit touches one map key.

    Deletes tombstone the dense row (mask_len -1, never matched) and
    re-resolve only the trie node the key leaf-pushed into
    (VarTrie.repush_node); adds reuse tombstoned rows, else append.
    ``snapshot()`` packs the live state into CompiledTables, equal array
    for array to the JAX package's snapshot after the same edits.  Dirty
    tracking records the dense rows and trie slot rows each edit writes;
    ``peek_dirty()`` hands them to ``TorchClassifier.load_tables`` as its
    hint, and ``clear_dirty()`` starts over once a load has applied them.

    The {LpmKey: rules} maps of a columnar build are made from its columns
    on the first edit only."""

    def __init__(self, rule_width: int, n_levels: int) -> None:
        self.rule_width = rule_width
        self.trie = VarTrie(n_levels, incremental=True)
        self._cap = 0
        self._size = 0
        self._seq_next = 0
        self._consumed = False
        self._dirty_t: Optional[List[np.ndarray]] = None  # None = off
        self._dirty_invalid = False
        self._key_words = np.zeros((0, 5), np.uint32)
        self._mask_words = np.zeros((0, 5), np.uint32)
        self._mask_len = np.zeros(0, np.int32)
        self._rules = np.zeros((0, rule_width, RULE_COLS), np.int32)
        self._ip = np.zeros((0, 16), np.uint8)
        self._term_level = np.zeros(0, np.int32)
        self._term_node = np.zeros(0, np.int32)
        self._seq_arr = np.zeros(0, np.int64)
        self._live = np.zeros(0, bool)
        self._free: List[int] = []
        # the masked identity -> row / key maps and the content map; None
        # until built from _lazy_cols (a columnar build)
        self._i2t: Optional[Dict[Tuple[int, int, bytes], int]] = {}
        self._i2k: Optional[Dict[Tuple[int, int, bytes], LpmKey]] = {}
        self._content: Optional[Dict[LpmKey, np.ndarray]] = {}
        self._lazy_cols = None  # (plen, ifx, unmasked ip, rules) or None
        self._max_ifindex = 0

    # -- the lazily built maps -----------------------------------------------

    def _materialize_maps(self) -> None:
        if self._content is not None:
            return
        plen, ifx, ip_u, rules = self._lazy_cols
        ip_b = np.ascontiguousarray(ip_u, np.uint8).tobytes()
        masked_b = np.ascontiguousarray(self._ip[: len(plen)]).tobytes()
        content, i2t, i2k = {}, {}, {}
        for t in range(len(plen)):
            key = LpmKey(int(plen[t]), int(ifx[t]), ip_b[16 * t : 16 * t + 16])
            ident = (key.prefix_len, key.ingress_ifindex, masked_b[16 * t : 16 * t + 16])
            content[key] = rules[t]
            i2t[ident] = t
            i2k[ident] = key
        self._content, self._i2t, self._i2k = content, i2t, i2k

    @property
    def content(self) -> Dict[LpmKey, np.ndarray]:
        self._materialize_maps()
        return self._content

    @property
    def _ident_to_t(self) -> Dict[Tuple[int, int, bytes], int]:
        self._materialize_maps()
        return self._i2t

    @property
    def _ident_to_key(self) -> Dict[Tuple[int, int, bytes], LpmKey]:
        self._materialize_maps()
        return self._i2k

    # -- construction --------------------------------------------------------

    @classmethod
    def from_content(cls, content: Mapping[LpmKey, np.ndarray],
                     rule_width: int = MAX_RULES_PER_TARGET,
                     min_trie_levels: int = 1) -> "IncrementalTables":
        """Build from a content map (columns_from_content, then
        from_columns)."""
        return cls.from_columns(columns_from_content(content, rule_width),
                                rule_width=rule_width, min_trie_levels=min_trie_levels)

    @classmethod
    def from_columns(cls, cols: TableColumns, rule_width: int = MAX_RULES_PER_TARGET,
                     min_trie_levels: int = 1) -> "IncrementalTables":
        """The columnar build: masked-identity dedup (last writer wins,
        first occurrence order), dense packing and the trie's batch insert,
        with no per-key Python; the maps are built on the first edit.  The
        dirty hint stays invalid until the first clear_dirty(): no device
        holds this build yet, so an empty hint would patch nothing."""
        _validate_columns(cols)
        win, masked, trie_order = _dedup_columns(cols)
        T = len(win)
        R = rule_width
        mask_len = cols.mask_len[win]
        ifindex = np.asarray(cols.ifindex, np.int64)[win]
        ip = np.ascontiguousarray(masked[win])  # dense rows and the trie: MASKED bytes
        rules_win = np.asarray(cols.rules, np.int32)[win]
        if rules_win.shape[1] == R:
            rules_t = rules_win
        else:
            rules_t = np.zeros((T, R, RULE_COLS), np.int32)
            w = min(rules_win.shape[1], R)
            rules_t[:, :w] = rules_win[:, :w]
        max_mask = int(mask_len.max()) if T else 0
        self = cls(R, max(trie_levels_for_mask(max_mask), min_trie_levels))
        self._bulk_init(ifindex, ip, mask_len, rules_t, sort_hint=trie_order)
        self._content = self._i2t = self._i2k = None
        self._lazy_cols = (np.asarray(cols.prefix_len, np.int32)[win], ifindex,
                           np.ascontiguousarray(cols.ip[win]), rules_win)
        self.start_dirty_tracking()
        self._dirty_invalid = True
        return self

    # -- dirty hints ---------------------------------------------------------

    def start_dirty_tracking(self) -> None:
        self._dirty_t = []
        self._dirty_invalid = False
        self.trie.start_dirty_tracking()

    def _record_t(self, t) -> None:
        if self._dirty_t is not None:
            self._dirty_t.append(np.atleast_1d(np.asarray(t, np.int64)))

    def peek_dirty(self) -> Optional[Dict]:
        """The rows written since the last clear_dirty(), as {"dense":
        rows, "levels": [slot rows per level]}, a superset of the rows that
        changed; None when tracking is off or a compaction invalidated it.
        A caller clears only after the device has applied the hint, so a
        failed load keeps accumulating."""
        if self._dirty_t is None or self._dirty_invalid:
            return None
        levels = self.trie.drain_dirty()
        if levels is None:
            return None
        dense = np.unique(np.concatenate(self._dirty_t)) if self._dirty_t else np.zeros(0, np.int64)
        return {"dense": dense, "levels": levels}

    def clear_dirty(self) -> None:
        self.start_dirty_tracking()

    def _ensure_cap(self, n: int) -> None:
        if n <= self._cap:
            return
        cap = max(n, 2 * self._cap, 16)
        grow = cap - self._cap

        def grown(a: np.ndarray) -> np.ndarray:
            return np.concatenate([a, np.zeros((grow,) + a.shape[1:], a.dtype)])

        self._key_words = grown(self._key_words)
        self._mask_words = grown(self._mask_words)
        self._mask_len = grown(self._mask_len)
        self._rules = grown(self._rules)
        self._ip = grown(self._ip)
        self._term_level = grown(self._term_level)
        self._term_node = grown(self._term_node)
        self._seq_arr = grown(self._seq_arr)
        self._live = grown(self._live)
        self._cap = cap

    def _write_dense(self, t: np.ndarray, ifindex: np.ndarray, ip: np.ndarray,
                     mask_len: np.ndarray, rules: np.ndarray) -> None:
        self._key_words[t, 0] = ifindex
        self._key_words[t, 1:] = ip.reshape(len(t), 16).view(">u4").astype(np.uint32)
        self._mask_words[t, 0] = 0xFFFFFFFF
        self._mask_words[t, 1:] = _mask_words_vec(mask_len)
        self._mask_len[t] = mask_len
        self._rules[t] = rules
        self._ip[t] = ip
        self._live[t] = True

    def _bulk_init(self, ifindex: np.ndarray, ip: np.ndarray, mask_len: np.ndarray,
                   rules: np.ndarray, sort_hint: Optional[np.ndarray] = None) -> None:
        T = len(ifindex)
        self._ensure_cap(T)
        t = np.arange(T)
        self._write_dense(t, ifindex, ip, mask_len, rules)
        seq = np.arange(T, dtype=np.int64)
        self._seq_arr[:T] = seq
        self._seq_next = T
        lv, nd = self.trie.batch_insert(ifindex, ip, mask_len, t, seq, sort_hint=sort_hint)
        self._term_level[:T] = lv
        self._term_node[:T] = nd
        self._size = T
        self._max_ifindex = int(ifindex.max()) if T else 0

    # -- edits ---------------------------------------------------------------

    def fits(self, content: Mapping[LpmKey, np.ndarray]) -> bool:
        """Whether the trie is deep enough for every mask of ``content``."""
        max_mask = max((k.mask_len for k in content), default=0)
        return trie_levels_for_mask(max_mask) <= self.trie.n_levels

    def apply(self, upserts: Mapping[LpmKey, np.ndarray],
              deletes: Sequence[LpmKey] = ()) -> None:
        """Deletes first (tombstone + node-local re-push), then upserts:
        a live masked identity gets its rule rows rewritten in place, a new
        one takes a tombstoned row or appends.  Every key is validated
        before the first write."""
        if self._consumed:
            raise CompileError("tables were snapshot(consume=True)d; build a fresh "
                               "IncrementalTables")
        for key in upserts:
            _validate_key(key)
        for key in deletes:
            _validate_key(key)
        max_mask = max((k.mask_len for k in upserts), default=0)
        if trie_levels_for_mask(max_mask) > self.trie.n_levels:
            raise CompileError(f"mask_len {max_mask} exceeds trie depth "
                               f"({self.trie.n_levels} levels); rebuild required")
        dirty_nodes = set()
        for key in deletes:
            ident = key.masked_identity()
            t = self._ident_to_t.pop(ident, None)
            if t is None:
                continue
            self.content.pop(self._ident_to_key.pop(ident), None)
            self._live[t] = False
            self._mask_len[t] = -1
            self._key_words[t] = 0
            self._mask_words[t] = 0
            self._rules[t] = 0
            self._free.append(t)
            self._record_t(t)
            dirty_nodes.add((int(self._term_level[t]), int(self._term_node[t])))
        for level, node in dirty_nodes:
            n = self._size
            idx = np.nonzero(self._live[:n] & (self._term_level[:n] == level)
                             & (self._term_node[:n] == node))[0]
            self.trie.repush_node(level, node, self._ip[idx],
                                  self._mask_len[idx].astype(np.int64), idx, self._seq_arr[idx])

        # new keys deduplicated by masked identity (last writer wins), so
        # two aliasing keys in one call cannot make two live rows
        new_by_ident = {}
        for key, rows in upserts.items():
            ident = key.masked_identity()
            t = self._ident_to_t.get(ident)
            rows = np.asarray(rows, np.int32)
            padded = np.zeros((self.rule_width, RULE_COLS), np.int32)
            padded[: min(rows.shape[0], self.rule_width)] = rows[: self.rule_width]
            if t is not None:  # rules-only: the LPM structure is unchanged
                self._rules[t] = padded
                self._record_t(t)
                old_key = self._ident_to_key[ident]
                if old_key != key:
                    self.content.pop(old_key, None)
                    self._ident_to_key[ident] = key
                self.content[key] = rows
            else:
                new_by_ident[ident] = (key, rows, padded)
        if not new_by_ident:
            return
        new_keys = [k for k, _, _ in new_by_ident.values()]
        K = len(new_keys)
        slots = [self._free.pop() if self._free else None for _ in range(K)]
        self._ensure_cap(self._size + sum(1 for s in slots if s is None))
        t_ids = np.empty(K, np.int64)
        for i, s in enumerate(slots):
            if s is None:
                t_ids[i] = self._size
                self._size += 1
            else:
                t_ids[i] = s
        ifindex = np.fromiter((k.ingress_ifindex for k in new_keys), np.int64, count=K)
        mask_len = np.fromiter((k.mask_len for k in new_keys), np.int64, count=K)
        ip = np.frombuffer(b"".join(k.masked_identity()[2] for k in new_keys),
                           np.uint8).reshape(K, 16)
        self._write_dense(t_ids, ifindex, ip, mask_len,
                          np.stack([p for _, _, p in new_by_ident.values()]))
        seq = np.arange(self._seq_next, self._seq_next + K, dtype=np.int64)
        self._seq_next += K
        self._seq_arr[t_ids] = seq
        lv, nd = self.trie.batch_insert(ifindex, ip, mask_len, t_ids, seq)
        self._term_level[t_ids] = lv
        self._term_node[t_ids] = nd
        self._record_t(t_ids)
        self._max_ifindex = max(self._max_ifindex, int(ifindex.max()))
        for i, (ident, (key, rows, _)) in enumerate(new_by_ident.items()):
            self._ident_to_t[ident] = int(t_ids[i])
            self._ident_to_key[ident] = key
            self.content[key] = rows

    def maybe_compact(self) -> bool:
        """Rebuild from the live content when tombstones are the majority
        (more than 64 rows), so a table that shrank stops paying for dead
        rows.  The device holds the old row layout, so the dirty hint is
        invalid until the next clear_dirty()."""
        if self._size <= 64 or len(self._ident_to_t) * 2 > self._size:
            return False
        fresh = IncrementalTables.from_content(self.content, rule_width=self.rule_width,
                                               min_trie_levels=self.trie.n_levels)
        self.__dict__.update(fresh.__dict__)
        self._dirty_invalid = True
        return True

    # -- packing -------------------------------------------------------------

    def snapshot(self, consume: bool = False) -> CompiledTables:
        """CompiledTables of the current state.  ``consume`` hands the
        growth buffers over without copies; the instance takes no edit
        after it."""
        if self._consumed:
            raise CompileError("tables were snapshot(consume=True)d; buffers are gone")
        T = self._size
        n = max(T, 1)
        self._ensure_cap(n)  # an empty table keeps one zeroed padding row
        if consume:
            self._consumed = True
        trie_levels, root_lut = self.trie.arrays(self._max_ifindex, consume=consume)

        def take(a: np.ndarray) -> np.ndarray:
            if not consume:
                return a[:n].copy()
            a.resize((n,) + a.shape[1:], refcheck=False)
            return a

        if self._content is None:
            # the maps are not built: the snapshot gets its own lazy view of
            # the build's columns, which later edits never touch
            content = LazyContent(*self._lazy_cols)
        else:
            content = self.content if consume else dict(self.content)
        return CompiledTables(
            rule_width=self.rule_width, num_entries=T, key_words=take(self._key_words),
            mask_words=take(self._mask_words), mask_len=take(self._mask_len),
            rules=take(self._rules), trie_levels=trie_levels, root_lut=root_lut,
            content=content,
        )
