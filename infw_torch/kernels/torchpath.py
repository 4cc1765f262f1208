"""Wire and verdict layer of the classify path, in plain PyTorch.

Counterpart of the wire/verdict half of the JAX package's
``kernels/jaxpath.py``: unpacking the packed host-to-device wire
(``unpack_wire``, and ``unpack_wire8`` for the 8-byte format), the
ordered first-match rule scan, the XDP verdict and per-rule statistics
(``finalize``/``result_stats``), and the single-buffer device-to-host
packing of results + statistics (``fuse_wire_outputs``) with its host
inverse; and the plain trie and ctrie walks (``trie_walk``,
``ctrie_walk_rows``), the specifications of kernels K2 and K3.

Integer conventions (PyTorch has no general uint32 arithmetic):
- 32-bit words travel as int32 tensors holding the uint32 bit pattern;
  every right shift is arithmetic in torch, so each is followed by a mask
  no wider than the bits the shift keeps (a logical shift in effect);
- packed results ``(ruleId << 8) | action`` are int32 bit patterns;
- statistics are summed in int64 and reduced to int32 two's complement,
  reproducing the int32 wrap of the XLA ``segment_sum`` bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..compiler import trie_level_strides
from ..constants import (
    ALLOW,
    DENY,
    IPPROTO_ICMP,
    IPPROTO_ICMPV6,
    IPPROTO_SCTP,
    IPPROTO_TCP,
    IPPROTO_UDP,
    KIND_IPV4,
    KIND_IPV6,
    KIND_MALFORMED,
    MAX_TARGETS,
    XDP_DROP,
    XDP_PASS,
)
from ..packets import PacketBatch

STATS_COLS = 6  # allow, allow_hi, allow_lo, deny, deny_hi, deny_lo


class DeviceBatch(NamedTuple):
    """Struct-of-arrays packet batch on one device; every column is int32
    (``ip_words`` holds the uint32 bit patterns, shape (B, 4))."""

    kind: torch.Tensor
    l4_ok: torch.Tensor
    ifindex: torch.Tensor
    ip_words: torch.Tensor
    proto: torch.Tensor
    dst_port: torch.Tensor
    icmp_type: torch.Tensor
    icmp_code: torch.Tensor
    pkt_len: torch.Tensor


def resolve_device(device=None) -> torch.device:
    """The port's device rule for every function that puts operands on a
    device: None means the first CUDA card, a CUDA device without a card
    raises, and the CPU (the plain PyTorch versions) only when the caller
    names it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device; pass device='cpu' to run the plain PyTorch "
                "version on the CPU"
            )
        return torch.device("cuda:0")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device} requested but CUDA is unavailable")
    return device


def host_to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``: a copy on a CUDA device (of
    a page-locked array, such as an ingest-ring record's staged copy,
    without blocking the host: the caller keeps the array unchanged until
    the work that reads it has materialized), a copy on the CPU too, so the
    tensor never aliases the caller's array."""
    a = np.ascontiguousarray(a)
    if device.type != "cuda" or not a.flags.writeable:
        return torch.from_numpy(a.copy()).to(device)
    t = torch.from_numpy(a)
    return t.to(device, non_blocking=t.is_pinned())


def device_batch(batch: PacketBatch, device=None) -> DeviceBatch:
    """Host PacketBatch -> DeviceBatch on ``device`` (resolve_device)."""
    device = resolve_device(device)

    def put(a):
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a.astype(np.int32, copy=False)).to(device)

    return DeviceBatch(*(put(getattr(batch, f)) for f in DeviceBatch._fields))


def packet_fields(batch: DeviceBatch) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeviceBatch -> the kernels' (B, 8) int32 fields [kind, ifindex,
    proto, dst_port, icmp_type, icmp_code, l4_ok, pkt_len] and (B, 4) int32
    words operands."""
    fields = torch.stack(
        [
            batch.kind, batch.ifindex, batch.proto, batch.dst_port,
            batch.icmp_type, batch.icmp_code, batch.l4_ok, batch.pkt_len,
        ],
        dim=1,
    ).to(torch.int32)
    return fields, batch.ip_words.to(torch.int32).contiguous()


def batch_from_fields(fields: torch.Tensor, words: torch.Tensor) -> DeviceBatch:
    """Inverse of packet_fields (views, no copy)."""
    return DeviceBatch(
        kind=fields[:, 0], l4_ok=fields[:, 6], ifindex=fields[:, 1],
        ip_words=words, proto=fields[:, 2], dst_port=fields[:, 3],
        icmp_type=fields[:, 4], icmp_code=fields[:, 5], pkt_len=fields[:, 7],
    )


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 two's complement (value modulo 2^32)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def unpack_wire(wire: torch.Tensor) -> DeviceBatch:
    """Inverse of PacketBatch.pack_wire / pack_wire_v4 / packets.narrow_wire,
    discriminated by the wire width: (B, 7) full layout, (B, 4) v4-compact
    (IP word 0 only, high words zero), (B, 3) / (B, 6) the narrow layouts
    (ifindex folded into w0, dst_port overlaid with the ICMP fields in one
    l4 word).  ``wire`` is int32 holding the uint32 words."""
    w0 = wire[:, 0]
    w1 = wire[:, 1]
    width = wire.shape[1]
    narrow = width in (3, 6)
    ip_off = 2 if narrow else 3
    if width in (3, 4):
        ip_words = torch.cat(
            [wire[:, ip_off : ip_off + 1], wire.new_zeros((wire.shape[0], 3))], dim=1
        )
    else:
        ip_words = wire[:, ip_off : ip_off + 4]
    proto = (w0 >> 3) & 0xFF
    if narrow:
        is_icmp = (proto == IPPROTO_ICMP) | (proto == IPPROTO_ICMPV6)
        l4w = w1 & 0xFFFF
        zero = torch.zeros_like(l4w)
        ifindex = (w0 >> 11) & 0xFFFF
        dst_port = torch.where(is_icmp, zero, l4w)
        icmp_type = torch.where(is_icmp, l4w >> 8, zero)
        icmp_code = torch.where(is_icmp, l4w & 0xFF, zero)
        pkt_len = (w1 >> 16) & 0xFFFF
    else:
        ifindex = wire[:, 2]
        dst_port = w1 & 0xFFFF
        icmp_type = (w0 >> 11) & 0xFF
        icmp_code = (w0 >> 19) & 0xFF
        pkt_len = ((w1 >> 16) & 0xFFFF) | (((w0 >> 27) & 0x1F) << 16)
    return DeviceBatch(
        kind=w0 & 3,
        l4_ok=(w0 >> 2) & 1,
        ifindex=ifindex.contiguous(),
        ip_words=ip_words.contiguous(),
        proto=proto,
        dst_port=dst_port,
        icmp_type=icmp_type,
        icmp_code=icmp_code,
        pkt_len=pkt_len,
    )


def unpack_wire8(wire: torch.Tensor, ifmap: torch.Tensor) -> DeviceBatch:
    """Inverse of packets.wire8: (B, 2) int32 rows (uint32 words) plus the
    (16,) int32 ifindex dictionary.  pkt_len is ZERO: the format carries no
    lengths, so the caller computes byte statistics on the host from the
    verdicts (backend.base.stats_from_results) and never reads the device
    statistics of a wire8 classify."""
    w0 = wire[:, 0]
    proto = (w0 >> 3) & 0xFF
    is_icmp = (proto == IPPROTO_ICMP) | (proto == IPPROTO_ICMPV6)
    l4w = (w0 >> 15) & 0xFFFF
    ifd = (w0 >> 11) & 0xF
    zero = torch.zeros_like(proto)
    return DeviceBatch(
        kind=w0 & 3,
        l4_ok=(w0 >> 2) & 1,
        ifindex=ifmap[ifd.clamp(0, ifmap.shape[0] - 1).long()].to(torch.int32),
        ip_words=torch.cat([wire[:, 1:2], wire.new_zeros((wire.shape[0], 3))], dim=1),
        proto=proto,
        dst_port=torch.where(is_icmp, zero, l4w),
        icmp_type=torch.where(is_icmp, l4w >> 8, zero),
        icmp_code=torch.where(is_icmp, l4w & 0xFF, zero),
        pkt_len=zero,
    )


def rule_scan(rows: torch.Tensor, batch: DeviceBatch) -> torch.Tensor:
    """Ordered first-match scan (kernel.c:222-258) over already-gathered
    rule rows: (B, R, 7) int32, or (B, R, 5) int16 holding the uint16
    packed rows of layout.pack_rules_u16 (all-zero rows for packets
    without an LPM match -> ruleId 0 everywhere -> UNDEF).  Returns packed
    int32 results."""
    if rows.shape[-1] == 5:
        s = (rows.to(torch.int32) & 0xFFFF).unbind(-1)  # uint16 values
        rid, act = s[0] & 0xFF, s[0] >> 8
        rproto, it = s[1] & 0xFF, s[1] >> 8
        ic, ps, pe = s[2], s[3], s[4]
    else:
        rid, rproto, ps, pe, it, ic, act = rows.unbind(-1)  # each (B, R)
    proto = batch.proto[:, None]
    dport = batch.dst_port[:, None]
    valid = rid != 0
    proto_eq = (rproto != 0) & (rproto == proto)
    is_transport = (
        (rproto == IPPROTO_TCP) | (rproto == IPPROTO_UDP) | (rproto == IPPROTO_SCTP)
    )
    port_hit = torch.where(pe == 0, dport == ps, (dport >= ps) & (dport < pe))
    fam = torch.where(
        batch.kind == KIND_IPV4,
        torch.full_like(batch.kind, IPPROTO_ICMP),
        torch.full_like(batch.kind, IPPROTO_ICMPV6),
    )[:, None]
    icmp_hit = (
        (rproto == fam)
        & (it == batch.icmp_type[:, None])
        & (ic == batch.icmp_code[:, None])
    )
    hit = valid & ((proto_eq & ((is_transport & port_hit) | icmp_hit)) | (rproto == 0))

    R = rows.shape[1]
    if R == 0:  # no rule slots: nothing hits
        return torch.zeros(rows.shape[0], dtype=torch.int32, device=rows.device)
    idx = torch.arange(R, device=rows.device, dtype=torch.int32)[None, :]
    first = torch.where(hit, idx, R).min(dim=1).values
    any_hit = first < R
    pick = first.clamp(max=R - 1).long()[:, None]
    rid_f = rid.gather(1, pick)[:, 0].to(torch.int64)
    act_f = act.gather(1, pick)[:, 0].to(torch.int64)
    packed = ((rid_f & 0xFFFFFF) << 8) | (act_f & 0xFF)
    return wrap_int32(torch.where(any_hit, packed, 0))


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 tensors holding uint32 values in [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 uint32 values."""
    return x.to(torch.int64) & 0xFFFFFFFF


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 sums of uint32 values -> the int32 reading of their low 32
    bits, as int64."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x)


def trie_walk(trie_levels, trie_targets: torch.Tensor, root_lut: torch.Tensor,
              batch: DeviceBatch, rows_read: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Poptrie walk (layout.build_poptrie): the DIR-16 root level is one
    direct-indexed slot-row read; every deeper level reads one 18-word node
    row, and the child is child_base + rank(nib) over the child bitmap.  A
    target hit records a global index into ``trie_targets``, resolved once
    after the walk.  Returns the target index (int64) or -1.

    ``trie_levels`` are int32 tensors (uint32 bit patterns for the deep
    rows); the arithmetic runs in int64 masked to 32 bits.  Every read
    clamps its index and pairs it with a range mask, as the reference's
    clipped gathers do: an out-of-range lane stops descending, so an
    ifindex outside ``root_lut`` reads root 0.  Targets at a level cover
    prefixes ending in (prev boundary, boundary]; the IPv4 packet-side cap
    is the test ``bit_end <= cap`` (32 for IPv4, 128 for every other kind).
    ``rows_read``, when given, a (B,) int64 tensor, gains the number of
    deep node rows each packet's walk reads."""
    strides = trie_level_strides(len(trie_levels))
    lut_size = root_lut.shape[0]
    ifx = batch.ifindex.to(torch.int64)
    if_ok = (ifx >= 0) & (ifx < lut_size)
    root = torch.where(if_ok, root_lut[ifx.clamp(0, lut_size - 1)].to(torch.int64), 0)

    words = _u32(batch.ip_words)
    e0 = root * 65536 + (words[:, 0] >> 16)
    n0 = trie_levels[0].shape[0]
    in0 = (e0 >= 0) & (e0 < n0)
    rows0 = trie_levels[0][e0.clamp(0, n0 - 1)].to(torch.int64)
    best0 = torch.where(in0 & (rows0[:, 1] > 0), rows0[:, 1] - 1, -1)
    alive = in0 & (rows0[:, 0] > 0)  # child ids are stored + 1
    node = torch.where(alive, rows0[:, 0] - 1, 0)

    cap = torch.where(batch.kind == KIND_IPV4, 32, 128)
    win = torch.zeros_like(node)  # trie_targets[0] is the 0 sentinel
    widx8 = torch.arange(8, device=node.device)[None, :]
    bit_end = strides[0]
    for stride, tbl in zip(strides[1:], trie_levels[1:]):
        bit_start, bit_end = bit_end, bit_end + stride
        nib = (words[:, bit_start // 32] >> (32 - stride - bit_start % 32)) & ((1 << stride) - 1)
        n_l = tbl.shape[0]
        alive = alive & (node >= 0) & (node < n_l)
        if rows_read is not None:
            rows_read += alive
        r = _u32(tbl[node.clamp(0, n_l - 1)])
        w = (nib >> 5)[:, None]
        bit = nib & 31
        below = (1 << bit) - 1  # exact at bit 31: int64
        cb, tb = r[:, 2:10], r[:, 10:18]
        prefix = torch.where(widx8 < w, _popcount32(cb), 0).sum(dim=1)
        tprefix = torch.where(widx8 < w, _popcount32(tb), 0).sum(dim=1)
        cw = cb.gather(1, w)[:, 0]
        tw = tb.gather(1, w)[:, 0]
        ok_t = alive & (((tw >> bit) & 1) > 0) & (bit_end <= cap)
        win = torch.where(ok_t, (r[:, 1] + tprefix + _popcount32(tw & below)) & 0xFFFFFFFF, win)
        alive = alive & (((cw >> bit) & 1) > 0)
        # the child id is a uint32 sum read as int32 (a wrap reads as
        # negative and fails the next level's range test)
        child = (r[:, 0] + prefix + _popcount32(cw & below)) & 0xFFFFFFFF
        node = torch.where(alive, torch.where(child >= 2**31, child - 2**32, child), 0)
    win = torch.where(win >= 2**31, win - 2**32, win)  # int32 view
    n_t = trie_targets.shape[0]
    in_w = (win >= 0) & (win < n_t)
    tval = trie_targets[win.clamp(0, n_t - 1)].to(torch.int64)
    return torch.where(in_w & (tval > 0), tval - 1, best0)


def gather_rule_rows(rules: torch.Tensor, tidx: torch.Tensor) -> torch.Tensor:
    """(T, R, 7) rules, (B,) target indices -> (B, R, 7) rows for the scan;
    packets without a target (tidx < 0, or past the table) get all-zero
    rows -> ruleId 0 everywhere -> UNDEF."""
    T = rules.shape[0]
    ok = (tidx >= 0) & (tidx < T)
    rows = rules[tidx.clamp(0, T - 1)]
    return torch.where(ok[:, None, None], rows, 0)


def extract_ip_bits(ip_words: torch.Tensor, pos: torch.Tensor, n) -> torch.Tensor:
    """(B,) int64 values of the ``n`` bits at bit offset ``pos`` (both per
    lane) of the 128-bit address, ``ip_words`` (B, 4) holding its big-endian
    uint32 words (bit 0 is the top bit of word 0).  The window spans at most
    two words; the word index is clipped to [0, 4] and word 4 reads 0, so a
    window past bit 128 reads zeros.  n = 0 reads 0 and off = 0 takes no
    bits of the next word (the reference guards both shifts by 32); an n
    above 32, as uint32, shifts everything out."""
    words = _u32(ip_words)
    words = torch.cat([words, words.new_zeros((words.shape[0], 1))], 1)
    pos = pos.to(torch.int64)
    w = (pos >> 5).clamp(0, 4)
    lo = words.gather(1, w[:, None])[:, 0]
    hi = words.gather(1, (w + 1).clamp(max=4)[:, None])[:, 0]
    off = pos & 31
    hi_part = torch.where(off == 0, 0, hi >> (32 - off).clamp(max=31))
    top32 = ((lo << off) & 0xFFFFFFFF) | hi_part
    n = torch.as_tensor(n, dtype=torch.int64, device=pos.device) & 0xFFFFFFFF
    return torch.where((n == 0) | (n > 32), 0, top32 >> (32 - n).clamp(0, 32))


def ctrie_descend(nodes: torch.Tensor, batch: DeviceBatch, node: torch.Tensor,
                  alive: torch.Tensor, d_max: int,
                  rows_read: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``d_max`` skip-node steps over the merged node array
    (layout.build_cpoptrie; int32 bit patterns) from a resolved entry (node
    id + alive mask).  Each step checks the node's skip chain against the
    address bits at ``pos``, consumes its 8-bit stride and rank-indexes the
    contiguous children; a target counts only if its prefix ends within
    the kind's cap (32 bits for IPv4, 128 for every other kind).  Returns
    the winning flat target position (int64, 0 = none).  uint32 sums run in
    int64 masked to 32 bits and are read back as int32, as the reference's
    casts do.  ``rows_read``, when given, a (B,) int64 tensor, gains the
    number of node rows each packet's descent reads (its skip steps)."""
    n_nodes = nodes.shape[0]
    node = node.to(torch.int64)
    pos = torch.full_like(node, 16)
    cap = torch.where(batch.kind == KIND_IPV4, 32, 128)
    widx8 = torch.arange(8, device=node.device)[None, :]
    win = torch.zeros_like(node)
    for _ in range(d_max):
        alive = alive & (node >= 0) & (node < n_nodes)
        if rows_read is not None:
            rows_read += alive
        r = _u32(nodes[node.clamp(0, n_nodes - 1)])
        skip_len = _i32(r[:, 2])
        skip_ok = torch.where(skip_len > 0,
                              extract_ip_bits(batch.ip_words, pos, skip_len) == r[:, 3], True)
        alive = alive & skip_ok
        pos = pos + skip_len
        nib = extract_ip_bits(batch.ip_words, pos, 8)
        pos = pos + 8
        w = (nib >> 5)[:, None]
        bit = nib & 31
        below = (1 << bit) - 1  # exact at bit 31: int64
        cb, tb = r[:, 4:12], r[:, 12:20]
        prefix = torch.where(widx8 < w, _popcount32(cb), 0).sum(dim=1)
        tprefix = torch.where(widx8 < w, _popcount32(tb), 0).sum(dim=1)
        cw = cb.gather(1, w)[:, 0]
        tw = tb.gather(1, w)[:, 0]
        ok_t = alive & (((tw >> bit) & 1) > 0) & (pos <= cap)
        win = torch.where(ok_t, _i32(r[:, 1] + tprefix + _popcount32(tw & below)), win)
        alive = alive & (((cw >> bit) & 1) > 0)
        node = torch.where(alive, _i32(r[:, 0] + prefix + _popcount32(cw & below)), 0)
    return win


def ctrie_walk_rows(ct, batch: DeviceBatch, d_max: int,
                    rows_read: Optional[torch.Tensor] = None):
    """The compressed walk over ``ct`` (root_lut, l0, nodes, targets,
    joined; cwalk.CTrieTables): the DIR-16 root slot, then ctrie_descend,
    then the target resolve (the descent's target, else the root slot's).
    Returns ((B, 3 + 5R) int16 joined rows, all zero for packets without a
    match or past the table; (B,) int64 tidx + 1, 0 = none).  ``l0[:, 1]``
    holds tidx + 1 here, not a position.  ``rows_read`` as in
    ctrie_descend."""
    lut_size = ct.root_lut.shape[0]
    ifx = batch.ifindex.to(torch.int64)
    if_ok = (ifx >= 0) & (ifx < lut_size)
    root = torch.where(if_ok, ct.root_lut[ifx.clamp(0, lut_size - 1)].to(torch.int64), 0)
    e0 = root * 65536 + (_u32(batch.ip_words[:, 0]) >> 16)
    n0 = ct.l0.shape[0]
    in0 = (e0 >= 0) & (e0 < n0)
    rows0 = ct.l0[e0.clamp(0, n0 - 1)].to(torch.int64)
    best0 = torch.where(in0 & (rows0[:, 1] > 0), rows0[:, 1], 0)
    alive = in0 & (rows0[:, 0] > 0)
    node = torch.where(alive, rows0[:, 0] - 1, 0)
    win = ctrie_descend(ct.nodes, batch, node, alive, d_max, rows_read)
    n_t = ct.targets.shape[0]
    in_w = (win >= 0) & (win < n_t)
    tval = torch.where(in_w, ct.targets[win.clamp(0, n_t - 1)].to(torch.int64), 0)
    sel = torch.where(tval > 0, tval, best0)
    P = ct.joined.shape[0]
    in_j = (sel > 0) & (sel < P)
    rows = torch.where(in_j[:, None], ct.joined[sel.clamp(0, P - 1)], 0)
    return rows, sel


def joined_rule_rows(rows: torch.Tensor) -> torch.Tensor:
    """(B, 3 + 5R) int16 joined rows -> the (B, R, 5) rule_scan operand."""
    return rows[:, 3:].reshape(rows.shape[0], -1, 5)


def result_stats(result: torch.Tensor, batch: DeviceBatch) -> torch.Tensor:
    """(MAX_TARGETS, 6) int32 per-batch statistics from packed results
    (kernel.c:361-400: allow/deny only, ruleId < MAX_TARGETS).  Byte counts
    travel as (hi, lo) = (len >> 8, len & 0xFF) columns; sums wrap modulo
    2^32 exactly as the reference's int32 segment_sum does."""
    is_ip = (batch.kind == KIND_IPV4) | (batch.kind == KIND_IPV6)
    action = result & 0xFF
    rule_id = (result >> 8) & 0xFFFFFF
    allow = (action == ALLOW) & is_ip
    deny = (action == DENY) & is_ip
    recorded = (allow | deny) & (rule_id < MAX_TARGETS)
    sid = torch.where(recorded, rule_id, MAX_TARGETS).long()
    ln = batch.pkt_len.to(torch.int64)
    hi = (ln >> 8) & 0xFFFFFF
    lo = ln & 0xFF
    a = allow.to(torch.int64)
    d = deny.to(torch.int64)
    data = torch.stack([a, a * hi, a * lo, d, d * hi, d * lo], dim=1)
    stats = torch.zeros(
        (MAX_TARGETS + 1, STATS_COLS), dtype=torch.int64, device=result.device
    ).index_add_(0, sid, data)
    return wrap_int32(stats[:MAX_TARGETS])


def looked_up_results(result: torch.Tensor, batch: DeviceBatch) -> torch.Tensor:
    """The results finalize keeps: zero for packets that are not IP or whose
    L4 parse failed (kernel.c:412-439), int32."""
    is_ip = (batch.kind == KIND_IPV4) | (batch.kind == KIND_IPV6)
    return torch.where(is_ip & (batch.l4_ok != 0), result, 0).to(torch.int32)


def finalize(
    result: torch.Tensor, batch: DeviceBatch
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ethertype/kind dispatch and stats (kernel.c:412-457, 361-400).
    Returns (results int32, xdp int32, stats (MAX_TARGETS, 6) int32)."""
    is_ip = (batch.kind == KIND_IPV4) | (batch.kind == KIND_IPV6)
    result = looked_up_results(result, batch)
    action = result & 0xFF
    drop = torch.full_like(result, XDP_DROP)
    xdp = torch.where(
        (batch.kind == KIND_MALFORMED) | (is_ip & (action == DENY)),
        drop,
        torch.full_like(result, XDP_PASS),
    )
    return result, xdp, result_stats(result, batch)


def _pack_res16(res16: torch.Tensor) -> torch.Tensor:
    """(B,) 16-bit values -> ceil(B/2) int32 words, element 2k in the low
    half and 2k+1 in the high half (the little-endian u16-pair bitcast)."""
    r = res16.to(torch.int64) & 0xFFFF
    if r.shape[0] % 2:
        r = torch.cat([r, r.new_zeros(1)])
    pairs = r.view(-1, 2)
    return wrap_int32(pairs[:, 0] | (pairs[:, 1] << 16))


def unpack_res16_host(arr: np.ndarray, b: int) -> np.ndarray:
    u = arr.view(np.uint32)
    res16 = np.empty(len(u) * 2, np.uint16)
    res16[0::2] = u & 0xFFFF
    res16[1::2] = u >> 16
    return res16[:b]


def fuse_wire_outputs(res16: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """Pack (results_u16, stats_i32) into ONE int32 device buffer, so the
    host reads back once per batch: ceil(B/2) words of u16-pair-packed
    results, then the stats flattened."""
    return torch.cat([_pack_res16(res16), stats.reshape(-1)])


def split_wire_outputs(arr: np.ndarray, b: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host inverse of fuse_wire_outputs -> (results_u16[b], stats_i32)."""
    nw = (b + 1) // 2
    res16 = unpack_res16_host(arr[:nw], b)
    stats = arr[nw:].reshape(MAX_TARGETS, STATS_COLS)
    return res16[:b], stats


def host_finalize_wire(res16: np.ndarray, kind: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side completion of the wire path: widen results to u32 and
    rebuild the XDP verdict as finalize() does on the device
    (kernel.c:423-455 — malformed DROP, deny DROP, else PASS)."""
    results = res16.astype(np.uint32)
    action = results & 0xFF
    xdp = np.where(
        kind == KIND_MALFORMED,
        XDP_DROP,
        np.where(action == DENY, XDP_DROP, XDP_PASS),
    ).astype(np.int32)
    return results, xdp


def merge_stats_host(stats: np.ndarray) -> np.ndarray:
    """Device (MAX_TARGETS, 6) int32 -> host (MAX_TARGETS, 4) int64
    [allow_pkts, allow_bytes, deny_pkts, deny_bytes]."""
    s = stats.astype(np.int64)
    out = np.zeros((stats.shape[0], 4), np.int64)
    out[:, 0] = s[:, 0]
    out[:, 1] = s[:, 1] * 256 + s[:, 2]
    out[:, 2] = s[:, 3]
    out[:, 3] = s[:, 4] * 256 + s[:, 5]
    return out
