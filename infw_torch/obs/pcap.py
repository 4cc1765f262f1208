"""Raw ethernet frame parse and build.

Host-side replica of the XDP header parse
(bpf/ingress_node_firewall_kernel.c): the ethertype switch of
ingress_node_firewall_main (:423-439) and ip_extract_l4info (:95-174),
producing the struct-of-arrays PacketBatch the dataplane consumes.

Faithfulness notes (quirks kept on purpose):
- The kernel advances past a *fixed-size* iphdr (no IHL handling), so IPv4
  options would shift the L4 parse; the fixed 20-byte step is kept.
- Unknown L4 protocol or a truncated L4 header makes ip_extract_l4info
  return -1, so the lookup returns UNDEF and the packet PASSes (l4_ok=0
  here); a truncated *IP* header is the same condition (:103-105,112-114).
- A frame shorter than the ethernet header is KIND_MALFORMED, XDP_DROP
  (:423-426).
- dst_port is converted to host order (the kernel compares
  bpf_ntohs(dstPort), :236-243).

``build_frame`` and ``build_frames_bulk`` are the synthesis inverses, used
by tests and replay.
"""
from __future__ import annotations

import ipaddress
import struct
from typing import Optional, Sequence

import numpy as np

from ..constants import (
    ETH_P_IP,
    ETH_P_IPV6,
    IPPROTO_ICMP,
    IPPROTO_ICMPV6,
    IPPROTO_SCTP,
    IPPROTO_TCP,
    IPPROTO_UDP,
    KIND_IPV4,
    KIND_IPV6,
    KIND_MALFORMED,
    KIND_OTHER,
)
from ..packets import PacketBatch

ETH_HLEN = 14
IPV4_HLEN = 20   # sizeof(struct iphdr) — fixed, no IHL (kernel.c:103)
IPV6_HLEN = 40   # sizeof(struct ipv6hdr)
_L4_HLEN = {
    IPPROTO_TCP: 20,   # sizeof(struct tcphdr)
    IPPROTO_UDP: 8,    # sizeof(struct udphdr)
    IPPROTO_SCTP: 12,  # sizeof(struct sctphdr)
    IPPROTO_ICMP: 8,   # sizeof(struct icmphdr)
    IPPROTO_ICMPV6: 8, # sizeof(struct icmp6hdr)
}


def parse_frame(frame: bytes):
    """One frame -> (kind, l4_ok, ip_words[4], proto, dst_port, icmp_type,
    icmp_code, pkt_len)."""
    pkt_len = len(frame)
    if pkt_len < ETH_HLEN:
        return (KIND_MALFORMED, 0, (0, 0, 0, 0), 0, 0, 0, 0, pkt_len)
    ethertype = struct.unpack_from("!H", frame, 12)[0]
    if ethertype == ETH_P_IP:
        kind, ip_hlen = KIND_IPV4, IPV4_HLEN
    elif ethertype == ETH_P_IPV6:
        kind, ip_hlen = KIND_IPV6, IPV6_HLEN
    else:
        return (KIND_OTHER, 0, (0, 0, 0, 0), 0, 0, 0, 0, pkt_len)

    l4_off = ETH_HLEN + ip_hlen
    if pkt_len < l4_off:
        # truncated IP header: ip_extract_l4info returns -1 (:103-105)
        return (kind, 0, (0, 0, 0, 0), 0, 0, 0, 0, pkt_len)

    if kind == KIND_IPV4:
        proto = frame[ETH_HLEN + 9]
        src = frame[ETH_HLEN + 12 : ETH_HLEN + 16]
        words = (struct.unpack("!I", src)[0], 0, 0, 0)
    else:
        proto = frame[ETH_HLEN + 6]
        src = frame[ETH_HLEN + 8 : ETH_HLEN + 24]
        words = struct.unpack("!4I", src)

    hlen = _L4_HLEN.get(proto)
    if hlen is None or pkt_len < l4_off + hlen:
        return (kind, 0, words, proto, 0, 0, 0, pkt_len)

    dst_port = icmp_type = icmp_code = 0
    if proto in (IPPROTO_TCP, IPPROTO_UDP, IPPROTO_SCTP):
        dst_port = struct.unpack_from("!H", frame, l4_off + 2)[0]
    else:
        icmp_type = frame[l4_off]
        icmp_code = frame[l4_off + 1]
    return (kind, 1, words, proto, dst_port, icmp_type, icmp_code, pkt_len)


def parse_frames(frames: Sequence[bytes], ifindex) -> PacketBatch:
    """Frames + per-frame (or scalar) ingress ifindex -> PacketBatch."""
    b = len(frames)
    if np.isscalar(ifindex):
        ifindex = [int(ifindex)] * b
    kind = np.zeros(b, np.int32)
    l4_ok = np.zeros(b, np.int32)
    words = np.zeros((b, 4), np.uint32)
    proto = np.zeros(b, np.int32)
    dst_port = np.zeros(b, np.int32)
    icmp_type = np.zeros(b, np.int32)
    icmp_code = np.zeros(b, np.int32)
    pkt_len = np.zeros(b, np.int32)
    for i, frame in enumerate(frames):
        k, ok, w, p, dp, it, ic, pl = parse_frame(frame)
        kind[i], l4_ok[i], proto[i], dst_port[i] = k, ok, p, dp
        icmp_type[i], icmp_code[i], pkt_len[i] = it, ic, pl
        words[i] = w
    return PacketBatch(
        kind=kind,
        l4_ok=l4_ok,
        ifindex=np.asarray(ifindex, np.int32),
        ip_words=words,
        proto=proto,
        dst_port=dst_port,
        icmp_type=icmp_type,
        icmp_code=icmp_code,
        pkt_len=pkt_len,
    )


class FramesBuf:
    """Zero-copy frames container: one contiguous byte buffer + per-frame
    (offset, length, ifindex) arrays.  The scale-tier representation —
    10M frames are 3 NumPy arrays and one buffer, not 10M Python bytes
    objects.  Indexable like a Sequence[bytes] so the deny-event capture
    path (which touches at most ring-capacity frames) can slice lazily."""

    __slots__ = ("buf", "offsets", "lengths", "ifindex")

    def __init__(self, buf: np.ndarray, offsets: np.ndarray,
                 lengths: np.ndarray, ifindex: np.ndarray) -> None:
        self.buf = buf
        self.offsets = offsets
        self.lengths = lengths
        self.ifindex = ifindex

    @classmethod
    def from_lengths(cls, buf: np.ndarray, lengths: np.ndarray,
                     ifindex) -> "FramesBuf":
        """Offsets derived from lengths (int64 accumulation, so >4GB
        buffers don't overflow u32) — the one place the idiom lives."""
        if np.isscalar(ifindex):
            ifindex = np.full(len(lengths), int(ifindex), np.uint32)
        offsets = np.zeros(len(lengths), np.int64)
        np.cumsum(lengths[:-1], out=offsets[1:])
        return cls(buf, offsets, np.asarray(lengths, np.uint32),
                   np.asarray(ifindex, np.uint32))

    @classmethod
    def from_frames(cls, frames: Sequence[bytes], ifindex) -> "FramesBuf":
        lengths = np.fromiter((len(f) for f in frames), np.uint32,
                              count=len(frames))
        buf = np.frombuffer(b"".join(frames), np.uint8) if frames else \
            np.zeros(0, np.uint8)
        return cls.from_lengths(buf, lengths, ifindex)

    def __len__(self) -> int:
        return len(self.lengths)

    def __getitem__(self, i: int) -> bytes:
        off = int(self.offsets[i])
        return self.buf[off : off + int(self.lengths[i])].tobytes()


def _be16_at(buf: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Big-endian u16 gather at byte positions ``pos`` (all in-bounds)."""
    return (buf[pos].astype(np.int32) << 8) | buf[pos + 1]


def _be32w_at(buf: np.ndarray, pos: np.ndarray, n_words: int) -> np.ndarray:
    """(len(pos), n_words) big-endian u32 gather starting at ``pos``."""
    idx = pos[:, None] + np.arange(4 * n_words)
    by = buf[idx].astype(np.uint32).reshape(len(pos), n_words, 4)
    return (by[..., 0] << 24) | (by[..., 1] << 16) | (by[..., 2] << 8) | by[..., 3]


_L4_HLEN_LUT = np.full(256, -1, np.int32)
for _p, _h in _L4_HLEN.items():
    _L4_HLEN_LUT[_p] = _h


def parse_frames_buf(fb: FramesBuf) -> PacketBatch:
    """Parse a FramesBuf into a PacketBatch, bit-exact with the scalar
    parse_frame (the same kernel.c quirks): vectorized NumPy whose gathers
    run over subset index arrays (np.nonzero of each family mask), never
    masked full-batch positions, so every byte read is for a row that needs
    it and subset membership already proves the read in bounds."""
    b = len(fb)
    if b == 0:
        return parse_frames([], [])
    buf = fb.buf
    off = fb.offsets
    pkt_len = fb.lengths.astype(np.int32)

    kind = np.full(b, KIND_OTHER, np.int32)
    malformed = pkt_len < ETH_HLEN
    kind[malformed] = KIND_MALFORMED

    has_eth = ~malformed
    ie = np.nonzero(has_eth)[0]
    ethertype = np.zeros(b, np.int32)
    ethertype[ie] = _be16_at(buf, off[ie] + 12)
    is_v4 = has_eth & (ethertype == ETH_P_IP)
    is_v6 = has_eth & (ethertype == ETH_P_IPV6)
    kind[is_v4] = KIND_IPV4
    kind[is_v6] = KIND_IPV6

    ip_hlen = np.where(is_v4, IPV4_HLEN, IPV6_HLEN)
    l4_off = off + ETH_HLEN + ip_hlen
    ip_ok = (is_v4 | is_v6) & (pkt_len >= ETH_HLEN + ip_hlen)

    proto = np.zeros(b, np.int32)
    i4 = np.nonzero(ip_ok & is_v4)[0]
    i6 = np.nonzero(ip_ok & is_v6)[0]
    proto[i4] = buf[off[i4] + ETH_HLEN + 9]
    proto[i6] = buf[off[i6] + ETH_HLEN + 6]

    words = np.zeros((b, 4), np.uint32)
    words[i4, 0] = _be32w_at(buf, off[i4] + ETH_HLEN + 12, 1)[:, 0]
    words[i6] = _be32w_at(buf, off[i6] + ETH_HLEN + 8, 4)

    hlen = _L4_HLEN_LUT[proto]
    l4_ok = ip_ok & (hlen >= 0) & (pkt_len >= ETH_HLEN + ip_hlen + hlen)
    is_transport = (
        (proto == IPPROTO_TCP) | (proto == IPPROTO_UDP) | (proto == IPPROTO_SCTP)
    )
    itr = np.nonzero(l4_ok & is_transport)[0]
    iic = np.nonzero(l4_ok & ~is_transport)[0]
    dst_port = np.zeros(b, np.int32)
    dst_port[itr] = _be16_at(buf, l4_off[itr] + 2)
    icmp_type = np.zeros(b, np.int32)
    icmp_code = np.zeros(b, np.int32)
    icmp_type[iic] = buf[l4_off[iic]]
    icmp_code[iic] = buf[l4_off[iic] + 1]

    return PacketBatch(
        kind=kind,
        l4_ok=l4_ok.astype(np.int32),
        ifindex=fb.ifindex.astype(np.int32),
        ip_words=words,
        proto=proto,
        dst_port=dst_port,
        icmp_type=icmp_type,
        icmp_code=icmp_code,
        pkt_len=pkt_len,
    )


def build_frames_bulk(
    kind: np.ndarray,
    ip_words: np.ndarray,
    proto: np.ndarray,
    dst_port: np.ndarray,
    icmp_type: np.ndarray,
    icmp_code: np.ndarray,
    l4_ok: Optional[np.ndarray] = None,
) -> "FramesBuf":
    """Vectorized build_frame for replay-scale synthesis: given the batch
    fields, emit minimal well-formed ethernet frames (v4/v6 + TCP/UDP/
    SCTP/ICMP) into one FramesBuf.  KIND_MALFORMED rows become truncated
    8-byte frames, KIND_OTHER rows an ARP-ethertype frame; rows with an
    unknown L4 proto (or l4_ok == 0) get a headerless IP frame so the
    parser reproduces l4_ok=0.  Inverse of parse_frames_buf for all fields
    the classifier consumes (dst addr/ports are fixed filler)."""
    b = len(kind)
    kind = np.asarray(kind, np.int32)
    proto = np.asarray(proto, np.int32)
    known = _L4_HLEN_LUT[proto] >= 0
    if l4_ok is None:
        l4_ok = np.ones(b, bool)
    else:
        l4_ok = np.asarray(l4_ok).astype(bool)
    hlen = np.where(known & l4_ok, np.maximum(_L4_HLEN_LUT[proto], 0), 0)

    is_v4 = kind == KIND_IPV4
    is_v6 = kind == KIND_IPV6
    is_mal = kind == KIND_MALFORMED
    ip_hlen = np.where(is_v4, IPV4_HLEN, np.where(is_v6, IPV6_HLEN, 0))
    lengths = np.where(
        is_mal, 8, ETH_HLEN + ip_hlen + np.where(is_v4 | is_v6, hlen, 0)
    ).astype(np.uint32)
    total = int(lengths.astype(np.int64).sum())
    buf = np.zeros(total, np.uint8)
    fb = FramesBuf.from_lengths(buf, lengths, np.zeros(b, np.uint32))
    offsets = fb.offsets

    def put8(pos, val, mask):
        p = pos[mask]
        buf[p] = np.asarray(val, np.uint8)[mask] if np.ndim(val) else np.uint8(val)

    def put16(pos, val, mask):
        v = np.broadcast_to(np.asarray(val, np.uint32), (b,))
        p = pos[mask]
        buf[p] = (v[mask] >> 8).astype(np.uint8)
        buf[p + 1] = (v[mask] & 0xFF).astype(np.uint8)

    # ethernet: macs zero-filled are fine; ethertype at +12
    eth_ok = ~is_mal
    ethertype = np.where(is_v4, ETH_P_IP, np.where(is_v6, ETH_P_IPV6, 0x0806))
    put16(offsets + 12, ethertype, eth_ok)

    # ipv4 header (fixed 20B, kernel parses fixed-size — no options)
    v = is_v4
    put8(offsets + ETH_HLEN, 0x45, v)
    put16(offsets + ETH_HLEN + 2, (IPV4_HLEN + hlen).astype(np.uint32), v)
    put8(offsets + ETH_HLEN + 8, 64, v)
    put8(offsets + ETH_HLEN + 9, proto, v)
    src_pos = offsets + ETH_HLEN + 12
    w0 = np.asarray(ip_words[:, 0], np.uint32)
    for k in range(4):
        put8(src_pos + k, (w0 >> (24 - 8 * k)) & 0xFF, v)
    put8(offsets + ETH_HLEN + 16, 10, v)  # dst 10.0.0.1 filler
    put8(offsets + ETH_HLEN + 19, 1, v)

    # ipv6 header (40B)
    v = is_v6
    put8(offsets + ETH_HLEN, 6 << 4, v)
    put16(offsets + ETH_HLEN + 4, hlen.astype(np.uint32), v)
    put8(offsets + ETH_HLEN + 6, proto, v)
    put8(offsets + ETH_HLEN + 7, 64, v)
    for w in range(4):
        ww = np.asarray(ip_words[:, w], np.uint32)
        for k in range(4):
            put8(offsets + ETH_HLEN + 8 + 4 * w + k, (ww >> (24 - 8 * k)) & 0xFF, v)
    put8(offsets + ETH_HLEN + 39, 1, v)  # dst ::1 filler

    # L4
    l4_pos = offsets + ETH_HLEN + ip_hlen
    has_l4 = (is_v4 | is_v6) & (hlen > 0)
    is_tr = (
        (proto == IPPROTO_TCP) | (proto == IPPROTO_UDP) | (proto == IPPROTO_SCTP)
    )
    put16(l4_pos + 2, np.asarray(dst_port, np.uint32), has_l4 & is_tr)
    is_ic = (proto == IPPROTO_ICMP) | (proto == IPPROTO_ICMPV6)
    put8(l4_pos, icmp_type, has_l4 & is_ic)
    put8(l4_pos + 1, icmp_code, has_l4 & is_ic)

    return fb


def build_frame(
    src_ip: str,
    dst_ip: str,
    proto: int,
    src_port: int = 0,
    dst_port: int = 0,
    icmp_type: int = 0,
    icmp_code: int = 0,
    payload: bytes = b"",
    ethertype: Optional[int] = None,
    src_mac: bytes = b"\x02\x00\x00\x00\x00\x01",
    dst_mac: bytes = b"\x02\x00\x00\x00\x00\x02",
) -> bytes:
    """Synthesize a well-formed ethernet frame for replay/tests."""
    src = ipaddress.ip_address(src_ip)
    dst = ipaddress.ip_address(dst_ip)
    is_v4 = src.version == 4
    if ethertype is None:
        ethertype = ETH_P_IP if is_v4 else ETH_P_IPV6

    if proto in (IPPROTO_TCP,):
        l4 = struct.pack("!HHIIBBHHH", src_port, dst_port, 0, 0, 5 << 4, 0, 0, 0, 0)
    elif proto == IPPROTO_UDP:
        l4 = struct.pack("!HHHH", src_port, dst_port, 8 + len(payload), 0)
    elif proto == IPPROTO_SCTP:
        l4 = struct.pack("!HHII", src_port, dst_port, 0, 0)
    elif proto in (IPPROTO_ICMP, IPPROTO_ICMPV6):
        l4 = struct.pack("!BBHI", icmp_type, icmp_code, 0, 0)
    else:
        l4 = b""
    l4 += payload

    if is_v4:
        total = IPV4_HLEN + len(l4)
        ip = struct.pack(
            "!BBHHHBBH4s4s",
            (4 << 4) | 5, 0, total, 0, 0, 64, proto, 0, src.packed, dst.packed,
        )
    else:
        ip = struct.pack(
            "!IHBB16s16s",
            (6 << 28), len(l4), proto, 64, src.packed, dst.packed,
        )
    eth = dst_mac + src_mac + struct.pack("!H", ethertype)
    return eth + ip + l4
