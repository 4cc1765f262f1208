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

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

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
    vectorized.  Ragged rule widths pad to the widest."""
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
    """Leaf-pushed variable-stride trie (16-bit root level + 8-bit levels),
    built once from a whole table with NumPy batch operations.

    Node 0 of every level is the null node; one level-0 root per ifindex.
    Level l packs [child node in level l+1 (0 = none), target + 1 (0 =
    none)] per slot.  Each slot holds the longest prefix that covers it;
    equal lengths resolve to the highest insertion sequence (last writer
    wins).  Node numbering follows (parent, slot) order level by level,
    which is the numbering the JAX package's builds give.
    """

    def __init__(self, n_levels: int):
        self.n_levels = max(1, n_levels)
        self.strides = trie_level_strides(self.n_levels)
        self.bit_ends = np.cumsum(self.strides).astype(np.int64)
        # flat per-level slot arrays, capacity-grown: n_cap * slots rows
        self._ct: List[np.ndarray] = [
            np.zeros((2 << s, 2), np.int32) for s in self.strides
        ]
        self.n_nodes: List[int] = [1] * self.n_levels  # incl. null node 0
        self.roots: Dict[int, int] = {}

    def _slots(self, level: int) -> int:
        return 1 << self.strides[level]

    def _alloc_nodes(self, level: int, count: int) -> int:
        """Allocate ``count`` fresh zeroed nodes; return the first id."""
        first = self.n_nodes[level]
        need = (first + count) * self._slots(level)
        cur = self._ct[level].shape[0]
        if need > cur:
            ct = np.zeros((max(need, 2 * cur), 2), np.int32)
            ct[:cur] = self._ct[level]
            self._ct[level] = ct
        self.n_nodes[level] += count
        return first

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
        target: np.ndarray, seq: np.ndarray, sort_hint: np.ndarray,
    ) -> None:
        """Insert E prefixes (masked address bytes) into this EMPTY trie.
        ``sort_hint`` is the (ifindex, address) ascending permutation of
        the entries (``_dedup_columns``'s ``trie_order``): one pass of
        neighbor compares per level allocates the child nodes, then each
        level's entries are leaf-pushed in address order, so their slot
        codes arrive nondecreasing and the winner sort is cheap."""
        if len(target) == 0:
            return
        mask_len = np.asarray(mask_len, np.int64)
        t_level = self.term_levels(mask_len)
        term_node = self._build_children(np.asarray(ifindex, np.int64), ip, t_level, sort_hint)
        tl_s = t_level[sort_hint]
        for l in np.unique(t_level):
            sel = sort_hint[tl_s == l]
            self._leaf_push(int(l), term_node[sel], ip[sel], mask_len[sel],
                            target[sel], seq[sel])

    def _build_children(
        self, ifindex: np.ndarray, ip: np.ndarray, t_level: np.ndarray,
        osort: np.ndarray,
    ) -> np.ndarray:
        """Child construction over the radix-ordered entries ``osort``:
        roots in ascending ifindex order, then each level's node
        allocation is a neighbor compare + cumsum over the sorted codes.
        Returns each entry's terminal node, in input order."""
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
        (mask_len + 1, seq).  Every level is pushed once per build into
        zeroed slots, so no resident priority needs comparing."""
        span = np.int64(1) << (self.bit_ends[level] - mask_len)
        base = self._level_slot(ip, level) & ~(span - 1)
        total = int(span.sum())
        if total == 0:
            return
        rep = np.repeat(np.arange(len(span)), span)
        offs = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(span) - span, span)
        flat = node.astype(np.int64)[rep] * self._slots(level) + base[rep] + offs
        # sorted by (slot, priority), each slot's last element is its winner;
        # priorities are unique because seq is
        if int(flat.max()) < (1 << 31) and int(seq.max()) < (1 << 24):
            rank = ((mask_len.astype(np.int64) + 1) << 24) | seq.astype(np.int64)
            order = np.argsort((flat << 32) | rank[rep], kind="stable")
        else:
            prio = ((mask_len.astype(np.int64) + 1) << 40) | seq.astype(np.int64)
            order = np.lexsort((prio[rep], flat))
        of = flat[order]
        wi = order[np.nonzero(np.append(of[1:] != of[:-1], True))[0]]
        self._ct[level][flat[wi], 1] = (target.astype(np.int64) + 1)[rep[wi]].astype(np.int32)

    def arrays(self, max_ifindex: int) -> Tuple[List[np.ndarray], np.ndarray]:
        """The device-layout level tables ((n_nodes_l * slots_l, 2) int32
        each) and the (max_ifindex + 1,) root LUT.  Shrinks the growth
        buffers in place and hands them out: the trie is done after this."""
        levels = []
        for l in range(self.n_levels):
            self._ct[l].resize((self.n_nodes[l] * self._slots(l), 2), refcheck=False)
            levels.append(self._ct[l])
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
    surviving entries is built at the end (the oracle reads it)."""
    tables, win = _compile_columns(cols, rule_width, min_trie_levels)
    ip = np.ascontiguousarray(cols.ip, np.uint8)
    tables.content = {
        LpmKey(int(cols.prefix_len[i]), int(cols.ifindex[i]), ip[i].tobytes()): cols.rules[i]
        for i in win.tolist()
    }
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
