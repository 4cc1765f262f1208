"""Batched packet representation and the host-to-device wire formats.

The reference's per-packet inputs are the XDP context fields consumed by
ingress_node_firewall_main and ip_extract_l4info
(bpf/ingress_node_firewall_kernel.c:95-174,412-439): ethertype, source IP,
L4 protocol, destination port or ICMP type/code, ingress ifindex and packet
length.  The dataplane consumes those fields as a struct-of-arrays batch.

Field conventions:
- ``kind``: KIND_* code for the ethertype switch outcome (constants.py);
- ``l4_ok``: 0 if ip_extract_l4info would have failed -> SET_ACTION(UNDEF);
- ``ip_words``: (B, 4) uint32 big-endian words of the 16-byte source-IP key
  data (IPv4 packets occupy word 0, rest zero — kernel.c:206-212);
- ``dst_port`` is host byte order; ``pkt_len`` is the full frame length.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .constants import IPPROTO_ICMP, IPPROTO_ICMPV6, KIND_IPV4, KIND_IPV6
from .netutil import ip_str_to_words

_FIELDS = (
    "kind", "l4_ok", "ifindex", "ip_words", "proto", "dst_port",
    "icmp_type", "icmp_code", "pkt_len",
)


@dataclass
class PacketBatch:
    kind: np.ndarray       # (B,) int32
    l4_ok: np.ndarray      # (B,) int32 (0/1)
    ifindex: np.ndarray    # (B,) int32
    ip_words: np.ndarray   # (B, 4) uint32
    proto: np.ndarray      # (B,) int32
    dst_port: np.ndarray   # (B,) int32
    icmp_type: np.ndarray  # (B,) int32
    icmp_code: np.ndarray  # (B,) int32
    pkt_len: np.ndarray    # (B,) int32

    def __len__(self) -> int:
        return int(self.kind.shape[0])

    def slice(self, start: int, stop: int) -> "PacketBatch":
        return PacketBatch(**{f: getattr(self, f)[start:stop] for f in _FIELDS})

    def take(self, idx: np.ndarray) -> "PacketBatch":
        return PacketBatch(**{f: getattr(self, f)[idx] for f in _FIELDS})

    def pack_wire(self) -> np.ndarray:
        """Pack into the (B, 7) uint32 wire format (28 B/packet):

          w0: kind(2) | l4_ok(1)<<2 | proto(8)<<3 | icmpType(8)<<11
              | icmpCode(8)<<19 | pktLenHi(5)<<27
          w1: dstPort(16) | pktLenLo(16)<<16
          w2: ifindex (full u32)
          w3..w6: ip_words

        pktLen carries 21 bits (clamped at 2 MiB - 1).  Device-side
        inverse: kernels.torchpath.unpack_wire."""
        out = np.empty((len(self), 7), np.uint32)
        self._pack_wire_header(out)
        out[:, 3:7] = self.ip_words.astype(np.uint32)
        return out

    def _pack_wire_header(self, out: np.ndarray) -> None:
        """w0..w2 of the wire layout (shared by the 7- and 4-word formats)."""
        plen = np.clip(self.pkt_len, 0, 0x1FFFFF).astype(np.uint32)
        out[:, 0] = (
            (self.kind.astype(np.uint32) & 3)
            | ((self.l4_ok.astype(np.uint32) & 1) << 2)
            | ((self.proto.astype(np.uint32) & 0xFF) << 3)
            | ((self.icmp_type.astype(np.uint32) & 0xFF) << 11)
            | ((self.icmp_code.astype(np.uint32) & 0xFF) << 19)
            | ((plen >> 16) << 27)
        )
        out[:, 1] = (self.dst_port.astype(np.uint32) & 0xFFFF) | (
            (plen & 0xFFFF) << 16
        )
        out[:, 2] = self.ifindex.astype(np.uint32)

    def is_v4_compactable(self) -> bool:
        """True when the batch can take the 4-word wire format: no IPv6
        packets and no nonzero high IP words."""
        return not bool(
            (np.asarray(self.kind) == KIND_IPV6).any()
        ) and not bool(np.asarray(self.ip_words)[:, 1:].any())

    def pack_wire_v4(self) -> np.ndarray:
        """The family-compact (B, 4) uint32 wire format (16 B/packet):
        w0..w2 as pack_wire, w3 = IP word 0.  Caller contract:
        is_v4_compactable()."""
        out = np.empty((len(self), 4), np.uint32)
        self._pack_wire_header(out)
        out[:, 3] = self.ip_words[:, 0].astype(np.uint32)
        return out

    def pack_wire_subset(self, idx: np.ndarray) -> Tuple[np.ndarray, bool]:
        """take(idx) then pack_wire[_v4] -> (wire, v4_only): the 4-word
        format when the subset is v4-compactable, the 7-word one otherwise;
        ``v4_only`` is True when the subset holds no IPv6 packet."""
        sub = self.take(np.asarray(idx, np.int64))
        wire = sub.pack_wire_v4() if sub.is_v4_compactable() else sub.pack_wire()
        return wire, not bool((np.asarray(sub.kind) == KIND_IPV6).any())


def make_batch(
    *,
    src: Sequence[str],
    proto: Sequence[int],
    ifindex: Sequence[int],
    dst_port: Optional[Sequence[int]] = None,
    icmp_type: Optional[Sequence[int]] = None,
    icmp_code: Optional[Sequence[int]] = None,
    pkt_len: Optional[Sequence[int]] = None,
    l4_ok: Optional[Sequence[int]] = None,
    kind: Optional[Sequence[int]] = None,
) -> PacketBatch:
    """Constructor from parallel per-packet field lists; ``src`` is a list
    of IP address strings and determines v4/v6 kind."""
    b = len(src)
    words = np.zeros((b, 4), np.uint32)
    kinds = np.zeros(b, np.int32)
    for i, addr in enumerate(src):
        w, is_v4 = ip_str_to_words(addr)
        words[i] = w
        kinds[i] = KIND_IPV4 if is_v4 else KIND_IPV6
    if kind is not None:
        kinds = np.asarray(kind, np.int32)

    def arr(x, default=0):
        if x is None:
            return np.full(b, default, np.int32)
        return np.asarray(x, np.int32)

    return PacketBatch(
        kind=kinds,
        l4_ok=arr(l4_ok, 1),
        ifindex=arr(ifindex),
        ip_words=words,
        proto=arr(proto),
        dst_port=arr(dst_port),
        icmp_type=arr(icmp_type),
        icmp_code=arr(icmp_code),
        pkt_len=arr(pkt_len, 64),
    )


def concat(batches: List[PacketBatch]) -> PacketBatch:
    return PacketBatch(
        **{f: np.concatenate([getattr(b, f) for b in batches]) for f in _FIELDS}
    )


def narrow_wire(w: np.ndarray):
    """(n, 4|7) wire -> the NARROW (n, 3|6) format, or None when the rows
    don't qualify.  Saves one word per packet on the host-to-device link by
    (a) folding the ifindex into w0 when every ifindex fits 16 bits, and
    (b) overlaying dst_port with the ICMP type/code in one 16-bit "l4
    word", which is lossless for classification: the ordered scan reads
    dst_port only for transport protocols and the ICMP fields only for the
    family's ICMP protocol (kernel.c:222-258), never both.  pkt_len must
    fit 16 bits so byte statistics stay exact.

    Narrow layout:
      w0: kind(2) | l4_ok(1)<<2 | proto(8)<<3 | ifindex(16)<<11
      w1: l4word(16) | pktLen(16)<<16
      w2..: ip word 0 (v4) / words 0..3 (v6)

    Device-side inverse: kernels.torchpath.unpack_wire (width 3/6)."""
    w0 = w[:, 0]
    ifx = w[:, 2]
    if int(w0.size) == 0:
        return np.zeros((0, w.shape[1] - 1), np.uint32)
    if (w0 >> 27).any() or (ifx >> 16).any():
        return None  # pkt_len >= 64KiB or wide ifindex: keep the full form
    proto = (w0 >> 3) & 0xFF
    is_icmp = (proto == IPPROTO_ICMP) | (proto == IPPROTO_ICMPV6)
    l4w = np.where(
        is_icmp,
        ((w0 >> 11) & 0xFF) << 8 | ((w0 >> 19) & 0xFF),
        w[:, 1] & 0xFFFF,
    ).astype(np.uint32)
    out = np.empty((w.shape[0], w.shape[1] - 1), np.uint32)
    out[:, 0] = (w0 & 0x7FF) | (ifx << 11)
    out[:, 1] = l4w | (w[:, 1] & 0xFFFF0000)  # pktLen low 16 stays in place
    out[:, 2:] = w[:, 3:]
    return out
