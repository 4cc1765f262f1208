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

import zlib
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


def _l4_word(w0: np.ndarray, w1: np.ndarray) -> np.ndarray:
    """The 16-bit l4 overlay shared by narrow_wire, wire8 and the delta
    codec: dst_port for transport rows, type<<8|code for the family ICMPs,
    lossless for classification because the ordered scan never reads both
    (kernel.c:222-258)."""
    proto = (w0 >> 3) & 0xFF
    is_icmp = (proto == IPPROTO_ICMP) | (proto == IPPROTO_ICMPV6)
    return np.where(
        is_icmp,
        ((w0 >> 11) & 0xFF) << 8 | ((w0 >> 19) & 0xFF),
        w1 & 0xFFFF,
    ).astype(np.uint32)


def _ifindex_dict(ifx: np.ndarray):
    """The ifindex dictionary shared by wire8 and the delta codec (at most
    15 distinct interfaces per chunk, a 16-slot ifmap padded with -1,
    4-bit indexes), so the two formats' eligibility cannot diverge.
    Returns (ifmap, ifdict), or None when the chunk exceeds the cap."""
    uniq = np.unique(ifx)
    if len(uniq) > 15:
        return None
    ifmap = np.full(16, -1, np.int32)
    ifmap[: len(uniq)] = uniq.astype(np.int64)
    return ifmap, np.searchsorted(uniq, ifx).astype(np.uint32)


def narrow_wire(w: np.ndarray):
    """(n, 4|7) wire -> the NARROW (n, 3|6) format, or None when the rows
    don't qualify.  Saves one word per packet on the host-to-device link by
    (a) folding the ifindex into w0 when every ifindex fits 16 bits, and
    (b) overlaying dst_port with the ICMP type/code in one 16-bit "l4
    word" (_l4_word).  pkt_len must fit 16 bits so byte statistics stay
    exact.

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
    l4w = _l4_word(w0, w[:, 1])
    out = np.empty((w.shape[0], w.shape[1] - 1), np.uint32)
    out[:, 0] = (w0 & 0x7FF) | (ifx << 11)
    out[:, 1] = l4w | (w[:, 1] & 0xFFFF0000)  # pktLen low 16 stays in place
    out[:, 2:] = w[:, 3:]
    return out


def wire8(w: np.ndarray):
    """(n, 4) v4-compact wire -> the 8-BYTE format, or None when the rows
    don't qualify: (n, 2) uint32 rows plus the (16,) int32 ifindex
    dictionary the device decodes through.

    Beyond the narrow form: classification never reads pkt_len (the host
    computes byte statistics exactly from the returned verdicts and its own
    pkt_len column, backend.base.stats_from_results), and a chunk rarely
    spans more than 15 interfaces, so a 4-bit dictionary index replaces the
    16-bit ifindex.

    Layout:  w0: kind(2) | l4_ok(1)<<2 | proto(8)<<3 | ifdict(4)<<11 |
                 l4word(16)<<15
             w1: ip word 0
    Device-side inverse: kernels.torchpath.unpack_wire8."""
    if w.shape[1] != 4:
        return None
    if w.shape[0] == 0:
        return np.zeros((0, 2), np.uint32), np.full(16, -1, np.int32)
    w0 = w[:, 0]
    d = _ifindex_dict(w[:, 2])
    if d is None:
        return None
    ifmap, ifdict = d
    l4w = _l4_word(w0, w[:, 1])
    out = np.empty((w.shape[0], 2), np.uint32)
    out[:, 0] = (w0 & 0x7FF) | (ifdict << 11) | (l4w << 15)
    out[:, 1] = w[:, 3]
    return out, ifmap


# --- delta+varint compressed wire (the sub-8-byte format) -------------------
#
# A chunk's IP words cluster under the table's prefixes, so sorting the
# chunk by IP and shipping varint-coded deltas averages 2-3 bytes where the
# raw word costs 4.  The sort permutation never crosses the link: the device
# classifies in sorted order and the host applies the inverse permutation
# to the returned verdicts (order is host-side bookkeeping, like pkt_len).
#
# Layout (three sections, offsets fully determined by (n, dict_mode,
# fixed_w)):
#   A: meta15 dictionary indexes, meta15 = kind(2) | l4_ok(1)<<2 |
#      proto(8)<<3 | ifdict(4)<<11 (the sub-l4 bits of wire8's w0):
#      dict_mode 0 = a single value, no section; 1 = <= 16 values, two
#      4-bit indexes per byte (the even packet in the low nibble); 2 = <=
#      256 values, one byte each.
#   B: the l4 word (_l4_word), 2 bytes little-endian per packet.
#   C: sorted-IP deltas: LEB128 varints (7 bits per byte, bit 7 =
#      continuation), or a fixed 1/2/4-byte little-endian stride when that
#      costs no more (fixed_w > 0).  The first "delta" is the absolute
#      first sorted IP word.
#
# Device-side inverse: kernels.wire_decode.decode_delta.  Host-side inverse
# and fail-closed validation: decode_delta_host below.

#: varint width thresholds: value v needs 1 + sum(v >= 2^(7k)) bytes
_VARINT_STEPS = tuple(np.uint64(1) << np.uint64(7 * k) for k in range(1, 5))


@dataclass
class DeltaWire:
    """One encoded chunk.  ``payload`` is what crosses the link (plus the
    small ``dict_vals``/``ifmap`` headers); ``perm`` stays on the host."""

    payload: np.ndarray    # (P,) uint8, sections A | B | C
    dict_vals: np.ndarray  # (D,) uint32 meta15 dictionary, D >= 1
    ifmap: np.ndarray      # (16,) int32 wire8-style ifindex dictionary
    perm: np.ndarray       # (n,) int64 sort permutation (host only)
    n: int
    dict_mode: int         # 0 = constant, 1 = 4-bit packed, 2 = u8
    fixed_w: int           # 0 = varint section C, else 1/2/4-byte stride
    crc: int               # crc32 over payload + dict_vals + ifmap

    @property
    def wire_bytes(self) -> int:
        return int(self.payload.nbytes)


def delta_section_offsets(n: int, dict_mode: int) -> Tuple[int, int]:
    """(offset of section B, offset of section C): the static layout shared
    with the device decoder."""
    n_a = 0 if dict_mode == 0 else ((n + 1) // 2 if dict_mode == 1 else n)
    return n_a, n_a + 2 * n


def varint_encode(vals: np.ndarray) -> np.ndarray:
    """Vectorized LEB128 encode of uint64 values (< 2^35: deltas are 32-bit,
    so at most 5 bytes each)."""
    v = np.ascontiguousarray(vals, np.uint64)
    nb = np.ones(len(v), np.int64)
    for step in _VARINT_STEPS:
        nb += v >= step
    ends = np.cumsum(nb)
    starts = ends - nb
    out = np.zeros(int(ends[-1]) if len(v) else 0, np.uint8)
    for k in range(5):
        m = nb > k
        if not m.any():
            break
        chunk = (v[m] >> np.uint64(7 * k)) & np.uint64(0x7F)
        cont = (nb[m] - 1 > k).astype(np.uint8) << 7
        out[starts[m] + k] = chunk.astype(np.uint8) | cont
    return out


def _delta_crc(payload: np.ndarray, dict_vals: np.ndarray, ifmap: np.ndarray) -> int:
    crc = zlib.crc32(np.ascontiguousarray(payload, np.uint8).tobytes())
    crc = zlib.crc32(np.ascontiguousarray(dict_vals, "<u4").tobytes(), crc)
    return zlib.crc32(np.ascontiguousarray(ifmap, "<i4").tobytes(), crc)


def encode_delta_wire(
    w: np.ndarray, max_bytes_per_pkt: Optional[float] = None
) -> Optional[DeltaWire]:
    """(n, 4) v4-compact wire -> DeltaWire, or None when the chunk does not
    qualify (not 4 words, more than 15 interfaces, more than 256 distinct
    meta15 values, n == 0) or, with ``max_bytes_per_pkt`` set (the auto
    codec's gate), when the payload would not beat that budget.  pkt_len
    never ships (host statistics); the ifindex travels as a 4-bit
    dictionary index, as in wire8."""
    if w.shape[1] != 4 or w.shape[0] == 0:
        return None
    n = w.shape[0]
    w0 = w[:, 0]
    d = _ifindex_dict(w[:, 2])
    if d is None:
        return None
    ifmap, ifdict = d
    meta15 = (w0 & 0x7FF) | (ifdict << 11)
    dict_vals, dict_idx = np.unique(meta15, return_inverse=True)
    if len(dict_vals) > 256:
        return None
    dict_mode = 0 if len(dict_vals) == 1 else (1 if len(dict_vals) <= 16 else 2)

    perm = np.argsort(w[:, 3], kind="stable").astype(np.int64)
    ip_sorted = w[perm, 3].astype(np.uint64)
    deltas = np.empty(n, np.uint64)
    deltas[0] = ip_sorted[0]
    np.subtract(ip_sorted[1:], ip_sorted[:-1], out=deltas[1:])
    var_c = varint_encode(deltas)
    # the fixed-stride plan: when every delta fits w bytes and the fixed
    # section costs no more than the varints
    fixed_w = 0
    dmax = int(deltas.max())
    for cand in (1, 2, 4):
        if dmax < (1 << (8 * cand)) and n * cand <= len(var_c):
            fixed_w = cand
            break

    l4 = _l4_word(w0, w[:, 1])[perm]
    midx = dict_idx[perm].astype(np.uint8)
    off_b, off_c = delta_section_offsets(n, dict_mode)
    c_len = n * fixed_w if fixed_w else len(var_c)
    payload = np.zeros(off_c + c_len, np.uint8)
    if dict_mode == 1:
        half = np.zeros(2 * ((n + 1) // 2), np.uint8)
        half[:n] = midx
        payload[:off_b] = half[0::2] | (half[1::2] << 4)
    elif dict_mode == 2:
        payload[:off_b] = midx
    payload[off_b:off_c] = l4.astype("<u2").view(np.uint8).reshape(n, 2).reshape(-1)
    if fixed_w:
        payload[off_c:] = (
            deltas.astype("<u8").view(np.uint8).reshape(n, 8)[:, :fixed_w].reshape(-1)
        )
    else:
        payload[off_c:] = var_c
    if max_bytes_per_pkt is not None and len(payload) >= max_bytes_per_pkt * n:
        return None
    return DeltaWire(
        payload=payload, dict_vals=dict_vals.astype(np.uint32), ifmap=ifmap,
        perm=perm, n=n, dict_mode=dict_mode, fixed_w=fixed_w,
        crc=_delta_crc(payload, dict_vals, ifmap),
    )


class DeltaDecodeError(ValueError):
    """Fail-closed decode failure: the stream is truncated, corrupt or
    structurally invalid.  Callers drop or deny the whole chunk; the codec
    never yields a best-effort partial decode."""


def _varint_decode_host(buf: np.ndarray, n: int) -> np.ndarray:
    """Strict LEB128 decode of exactly ``n`` values consuming the whole
    buffer; raises DeltaDecodeError on any structural violation (dangling
    continuation, runs above 5 bytes, wrong value count, trailing bytes)."""
    b = np.asarray(buf, np.uint8)
    if n == 0:
        if len(b):
            raise DeltaDecodeError("trailing bytes after 0-value stream")
        return np.zeros(0, np.uint64)
    if len(b) == 0:
        raise DeltaDecodeError("empty varint section")
    term = (b & 0x80) == 0
    n_vals = int(term.sum())
    if n_vals != n:
        raise DeltaDecodeError(f"varint stream holds {n_vals} values, expected {n}")
    if not term[-1]:
        raise DeltaDecodeError("dangling continuation byte at stream end")
    ends = np.nonzero(term)[0]
    starts = np.concatenate([[-1], ends[:-1]]) + 1
    lens = ends - starts + 1
    if int(lens.max()) > 5:
        raise DeltaDecodeError("varint run exceeds 5 bytes (32-bit domain)")
    vals = np.zeros(n, np.uint64)
    for k in range(5):
        m = lens > k
        if not m.any():
            break
        vals[m] |= (b[starts[m] + k].astype(np.uint64) & 0x7F) << np.uint64(7 * k)
    if int(vals.max()) > 0xFFFFFFFF:
        raise DeltaDecodeError("varint value exceeds 32 bits")
    return vals


def decode_delta_host(dw: DeltaWire) -> Tuple[np.ndarray, ...]:
    """CPU inverse and validation oracle of encode_delta_wire: the
    classification fields in SORTED (stream) order, (kind, l4_ok, ifindex,
    proto, dst_port, icmp_type, icmp_code, ip_word0) (pkt_len never ships).
    Raises DeltaDecodeError on any integrity violation: crc mismatch, bad
    section lengths, malformed varints, out-of-range dictionary indexes,
    delta sums past 2^32.  A corrupt stream denies the chunk; it never
    misclassifies."""
    n = int(dw.n)
    if n < 0:
        raise DeltaDecodeError("negative packet count")
    if dw.crc != _delta_crc(dw.payload, dw.dict_vals, dw.ifmap):
        raise DeltaDecodeError("payload crc mismatch")
    if dw.dict_mode not in (0, 1, 2) or dw.fixed_w not in (0, 1, 2, 4):
        raise DeltaDecodeError("invalid layout flags")
    if len(dw.dict_vals) < 1 or len(dw.dict_vals) > 256:
        raise DeltaDecodeError("invalid dictionary size")
    off_b, off_c = delta_section_offsets(n, dw.dict_mode)
    p = np.asarray(dw.payload, np.uint8)
    if len(p) < off_c:
        raise DeltaDecodeError("payload shorter than fixed sections")
    if dw.fixed_w and len(p) != off_c + n * dw.fixed_w:
        raise DeltaDecodeError("fixed-stride section length mismatch")
    if dw.dict_mode == 0:
        dict_idx = np.zeros(n, np.int64)
    elif dw.dict_mode == 1:
        half = p[:off_b]
        dict_idx = np.empty(2 * len(half), np.int64)
        dict_idx[0::2] = half & 0xF
        dict_idx[1::2] = half >> 4
        if n % 2 and dict_idx[n] != 0:
            raise DeltaDecodeError("nonzero padding nibble")
        dict_idx = dict_idx[:n]
    else:
        dict_idx = p[:n].astype(np.int64)
    if n and int(dict_idx.max()) >= len(dw.dict_vals):
        raise DeltaDecodeError("dictionary index out of range")
    l4 = p[off_b:off_c].view("<u2").astype(np.int64)
    if dw.fixed_w:
        raw = np.zeros((n, 8), np.uint8)
        raw[:, : dw.fixed_w] = p[off_c:].reshape(n, dw.fixed_w)
        deltas = raw.reshape(-1).view("<u8").astype(np.uint64)
    else:
        deltas = _varint_decode_host(p[off_c:], n)
    ip = np.cumsum(deltas, dtype=np.uint64)
    if n and int(ip[-1]) > 0xFFFFFFFF:
        raise DeltaDecodeError("delta sum overflows 32-bit IP word")
    meta = dw.dict_vals[dict_idx].astype(np.int64)
    kind = (meta & 3).astype(np.int32)
    l4_ok = ((meta >> 2) & 1).astype(np.int32)
    proto = ((meta >> 3) & 0xFF).astype(np.int32)
    ifd = ((meta >> 11) & 0xF).astype(np.int64)
    ifindex = np.asarray(dw.ifmap, np.int32)[ifd]
    is_icmp = (proto == IPPROTO_ICMP) | (proto == IPPROTO_ICMPV6)
    dst_port = np.where(is_icmp, 0, l4).astype(np.int32)
    icmp_type = np.where(is_icmp, l4 >> 8, 0).astype(np.int32)
    icmp_code = np.where(is_icmp, l4 & 0xFF, 0).astype(np.int32)
    return (kind, l4_ok, ifindex, proto, dst_port, icmp_type, icmp_code,
            ip.astype(np.uint32))
