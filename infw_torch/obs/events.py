"""Deny-event pipeline.

The reference path: the kernel emits a perf event per denied packet, a
header plus the first <= 256 bytes of the frame
(bpf/ingress_node_firewall_kernel.c:361-399); a daemon goroutine decodes it
and writes structured lines to syslog, which a sidecar prints
(pkg/ebpf/ingress_node_firewall_events.go:25-171, cmd/syslog/syslog.go).

Here the classifier's deny verdicts for a batch become records (deny only:
allow generates no event, kernel.c:446,450) pushed into a bounded ring that
tolerates overflow with a lost-sample counter (the perf ring's LostSamples
accounting, events.go:79-82); a consumer thread decodes them and writes the
same line format to a sink.  Replay-scale deny sets travel as one columnar
BatchDenyRecord and drain as 32-byte binary spill rows (the summary line
keeps the reference's "28B/event" text).  Other line records (one
PatchTxnRecord per flushed edit transaction, one TenantSwapRecord per
tenant lifecycle transition, one FlowEvictRecord per evicting insert, one
TelemetrySummaryRecord per telemetry drain, one AnomalyVerdictRecord per
anomaly-scoring drain and one TraceSpanRecord per sampled slow admission)
share the ring.
"""
from __future__ import annotations

import ipaddress
import struct
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .._threads import spawn
from ..constants import (
    DENY,
    ETH_P_IP,
    ETH_P_IPV6,
    IPPROTO_ICMP,
    IPPROTO_ICMPV6,
    IPPROTO_SCTP,
    IPPROTO_TCP,
    IPPROTO_UDP,
    MAX_EVENT_DATA,
    XDP_DROP,
    XDP_PASS,
    get_action,
    get_rule_id,
)
from .pcap import ETH_HLEN, IPV4_HLEN, IPV6_HLEN, _L4_HLEN


@dataclass
class EventHdr:
    """event_hdr_st (bpf/ingress_node_firewall.h:58-64)."""

    if_id: int
    rule_id: int
    action: int
    pkt_length: int

    def pack(self) -> bytes:
        """Little-endian wire layout derived from the Go-side decode
        (events.go:90-93) with one deliberate widening: ifId is u32, not
        u16 — Linux ifindexes routinely exceed 65535 on hosts with many
        netns veths and the compiler admits up to MAX_IFINDEX = 1<<20, so
        the reference's u16 would truncate (or, packed strictly, crash on)
        real deny events.  Layout: u32 ifId, u16 ruleId, u8 action, pad,
        u16 len."""
        return struct.pack("<IHBxH", self.if_id, self.rule_id, self.action,
                          self.pkt_length)

    @classmethod
    def unpack(cls, raw: bytes) -> "EventHdr":
        if_id, rule_id, action, pkt_length = struct.unpack_from("<IHBxH", raw)
        return cls(if_id=if_id, rule_id=rule_id, action=action, pkt_length=pkt_length)


@dataclass
class EventRecord:
    hdr: EventHdr
    packet: bytes  # first <= MAX_EVENT_DATA bytes of the raw frame


@dataclass
class BatchDenyRecord:
    """One ring item carrying a whole classify chunk's deny events as
    COLUMNS (deny-sliced numpy arrays) instead of per-event Python
    objects.

    At replay rates (millions of denies per pass) a per-event construction
    loop is the bottleneck and a bounded ring overflows at exactly the load
    the event stream exists for.  A batch record is O(1) ring bookkeeping
    on push and drains as ONE vectorized binary spill write, so the
    pipeline keeps up with the classify rate.  The reference's contract is
    overflow with accounting (events.go:79-82); this keeps the accounting."""

    ifindex: np.ndarray    # (n,) int32
    results: np.ndarray    # (n,) uint32 raw (ruleId<<8|action)
    pkt_len: np.ndarray    # (n,) int32
    kind: np.ndarray       # (n,) int32
    ip_words: np.ndarray   # (n, 4) uint32 src address words
    proto: np.ndarray      # (n,) int32
    dst_port: np.ndarray   # (n,) int32
    icmp_type: np.ndarray  # (n,) int32
    icmp_code: np.ndarray  # (n,) int32

    def __len__(self) -> int:
        return len(self.results)

    def slice(self, n: int) -> "BatchDenyRecord":
        return BatchDenyRecord(
            **{f: getattr(self, f)[:n] for f in (
                "ifindex", "results", "pkt_len", "kind", "ip_words",
                "proto", "dst_port", "icmp_type", "icmp_code")}
        )

    #: binary spill row layout (little-endian, 32 bytes):
    #: u32 ifindex, u32 result, u16 pkt_len, u8 kind, u8 proto,
    #: 16B src address (network order), u16 dst_port, u8 icmpType,
    #: u8 icmpCode
    SPILL_DTYPE = np.dtype([
        ("ifindex", "<u4"), ("result", "<u4"), ("pkt_len", "<u2"),
        ("kind", "u1"), ("proto", "u1"), ("src", "u1", 16),
        ("dst_port", "<u2"), ("icmp_type", "u1"), ("icmp_code", "u1"),
    ])

    def spill_rows(self) -> np.ndarray:
        """Vectorized structured rows for the binary spill sink."""
        n = len(self)
        out = np.zeros(n, self.SPILL_DTYPE)
        out["ifindex"] = self.ifindex.astype(np.uint32)
        out["result"] = self.results.astype(np.uint32)
        out["pkt_len"] = np.minimum(self.pkt_len, 0xFFFF).astype(np.uint16)
        out["kind"] = np.minimum(self.kind, 0xFF).astype(np.uint8)
        out["proto"] = (self.proto & 0xFF).astype(np.uint8)
        # big-endian words -> network byte order address bytes
        out["src"] = np.ascontiguousarray(
            self.ip_words.astype(">u4")
        ).view(np.uint8).reshape(n, 16)
        out["dst_port"] = (self.dst_port & 0xFFFF).astype(np.uint16)
        out["icmp_type"] = (self.icmp_type & 0xFF).astype(np.uint8)
        out["icmp_code"] = (self.icmp_code & 0xFF).astype(np.uint8)
        return out


@dataclass
class PatchTxnRecord:
    """One flushed multi-edit patch transaction (infw_torch.txn): how many
    ops coalesced, how many folded away (superseded/annihilated), the
    dirty-row count the device load shipped, why the flush tripped
    (deadline | batch | manual), and whether the transaction escalated to
    the columnar rebuild path.  Counters and the staleness histogram live
    on /metrics (TxnStats); the event carries the SHAPE of each flush in
    the same stream as deny events."""

    ops: int
    folded: int
    dirty_rows: int
    reason: str
    escalated: bool
    staleness_us: float = 0.0

    def lines(self) -> List[str]:
        esc = ", ESCALATED to rebuild" if self.escalated else ""
        return [
            f"patch-txn: {self.ops} op(s) ({self.folded} folded) -> "
            f"{self.dirty_rows} dirty row(s), flush={self.reason}, "
            f"worst staleness {self.staleness_us:.0f}us{esc}"
        ]


@dataclass
class TenantSwapRecord:
    """One tenant lifecycle transition on the multi-tenant paged arena
    (infw_torch.syncer.TenantRegistry): create / hot-swap / destroy, with
    the two halves of a swap timed separately: slab staging against the
    page-table row flip.  Counters (active slabs, swaps, compactions,
    per-tenant packets and verdicts) live on /metrics; the event carries
    the shape of each transition in the same stream as deny events."""

    tenant: str
    tenant_id: int
    page: int
    entries: int
    kind: str          # "create" | "swap" | "destroy" | "patch"
    stage_us: float = 0.0
    flip_us: float = 0.0

    def lines(self) -> List[str]:
        return [
            f"tenant-{self.kind}: {self.tenant!r} (id {self.tenant_id}) "
            f"page {self.page}, {self.entries} entries, "
            f"stage {self.stage_us:.0f}us + flip {self.flip_us:.0f}us"
        ]


@dataclass
class FlowEvictRecord:
    """One flow-tier insert that displaced live flows (LRU eviction under
    capacity pressure, infw_torch.flow).  The flow_* counters and the
    occupancy gauge live on /metrics; the event carries the shape of
    eviction pressure, one record per insert launch rather than per flow,
    in the same stream as deny events."""

    evicted: int
    inserted: int
    epoch: int

    def lines(self) -> List[str]:
        return [
            f"flow-evict: {self.evicted} flow(s) displaced by "
            f"{self.inserted} insert(s) at epoch {self.epoch}"
        ]


@dataclass
class TelemetrySummaryRecord:
    """One decimated drain window of the telemetry plane, exactly once
    (infw_torch.obs.telemetry): per-tenant traffic summaries (packets /
    allow / deny / pure-SYN counts with deny-storm and SYN-flood flags)
    and the window's heavy hitters decoded from the device top-K table.
    ``seq`` is the gap-free drain generation: consumers detect loss by
    sequence, not by absence."""

    seq: int
    admissions: int
    tenants: List[dict] = field(default_factory=list)
    top: List[dict] = field(default_factory=list)

    def lines(self) -> List[str]:
        out = [
            f"telemetry-summary seq={self.seq} "
            f"admissions={self.admissions} tenants={len(self.tenants)}"
        ]
        for t in self.tenants:
            flags = []
            if t.get("deny_storm"):
                flags.append("DENY-STORM")
            if t.get("syn_flood"):
                flags.append("SYN-FLOOD")
            tag = (" [" + ",".join(flags) + "]") if flags else ""
            out.append(
                f"\ttenant {t['tenant']}: {t['packets']} pkts, "
                f"{t['allow']} allow, {t['deny']} deny, "
                f"{t['syn']} syn{tag}"
            )
        for h in self.top:
            out.append(
                f"\ttop-talker tenant {h['tenant']} {h['src']} "
                f"{h['verdict']}: ~{h['count']} pkts"
            )
        return out


@dataclass
class AnomalyVerdictRecord:
    """One decimated drain window of the anomaly-scoring tier, exactly once
    (infw_torch.mlscore): per-tenant scored / anomalous / enforced counts
    with the window's max score and the tenant's policy row, and the
    window's most-anomalous sources decoded from the device feature table.
    ``seq`` is the gap-free drain generation."""

    seq: int
    admissions: int
    tenants: List[dict] = field(default_factory=list)
    top: List[dict] = field(default_factory=list)

    def lines(self) -> List[str]:
        out = [
            f"anomaly-verdict seq={self.seq} "
            f"admissions={self.admissions} tenants={len(self.tenants)}"
        ]
        for t in self.tenants:
            mode = "ENFORCE" if t.get("enforce") else "shadow"
            out.append(
                f"\ttenant {t['tenant']}: {t['scored']} scored, "
                f"{t['anom']} anomalous, {t['enforced']} enforced, "
                f"max {t['max_score']} (thr {t['threshold']}, {mode})"
            )
        for h in self.top:
            out.append(
                f"\tanomalous-src tenant {h['tenant']} {h['src']}: "
                f"{h['anom_hits']} hit(s), ~{h['pkts']} pkts"
            )
        return out


@dataclass
class TraceSpanRecord:
    """One sampled slow admission's per-stage span breakdown (the
    histograms carry the population; the record the shape of one
    outlier)."""

    total_us: float
    n_packets: int
    spans_us: Dict[str, float] = field(default_factory=dict)

    def lines(self) -> List[str]:
        parts = " ".join(
            f"{k}={v:.0f}us" for k, v in self.spans_us.items() if v > 0
        )
        return [
            f"trace-span: {self.total_us:.0f}us over {self.n_packets} "
            f"pkt(s) [{parts}]"
        ]


def convert_xdp_action_to_string(action: int) -> str:
    """convertXdpActionToString (events.go:173-181)."""
    if action == XDP_DROP:
        return "Drop"
    if action == XDP_PASS:
        return "Allow"
    return "invalid action"


class EventRing:
    """Bounded ring with lost-sample accounting (MAX_CPUS-slot perf ring,
    kernel.c:24-29; LostSamples handling events.go:79-82).

    Capacity counts EVENTS (a BatchDenyRecord occupies its batch size),
    so memory stays bounded at replay scale while single-event pushes
    keep the original semantics.  ``queued_total`` / ``lost_samples``
    feed the Prometheus counters."""

    #: bound on PER-EVENT records regardless of the event capacity:
    #: each carries up to MAX_EVENT_DATA frame bytes plus Python object
    #: overhead, so a multi-million EVENT capacity (sized for O(1)-ish
    #: batch records) must not translate into gigabytes of single
    #: records during a sub-threshold deny flood (~64K records ~ 16-32MB)
    PER_RECORD_CAP = 65536

    def __init__(self, capacity: int = 4096) -> None:
        self._lock = threading.Lock()
        self._ring: deque = deque()
        self._capacity = capacity
        self._count = 0  # queued events (batch items count their size)
        self._n_single = 0  # per-event records among them
        self.lost_samples = 0
        self.queued_total = 0

    def push(self, rec: EventRecord) -> None:
        with self._lock:
            if (
                self._count >= self._capacity
                or self._n_single >= self.PER_RECORD_CAP
            ):
                self.lost_samples += 1
                return
            self._ring.append(rec)
            self._count += 1
            self._n_single += 1
            self.queued_total += 1

    def push_batch(self, rec: BatchDenyRecord) -> None:
        """Queue a whole chunk's denies; a batch that does not fully fit
        is truncated with the overflow accounted as lost (partial
        delivery beats all-or-nothing at the boundary)."""
        n = len(rec)
        if n == 0:
            return
        with self._lock:
            room = self._capacity - self._count
            if room <= 0:
                self.lost_samples += n
                return
            if n > room:
                self.lost_samples += n - room
                rec = rec.slice(room)
                n = room
            self._ring.append(rec)
            self._count += n
            self.queued_total += n

    def is_full(self) -> bool:
        with self._lock:
            return self._count >= self._capacity

    def add_lost(self, n: int) -> None:
        with self._lock:
            self.lost_samples += n

    def pop_all(self) -> List:
        with self._lock:
            out = list(self._ring)
            self._ring.clear()
            self._count = 0
            self._n_single = 0
            return out

    def counter_values(self) -> dict:
        """Prometheus counter sources (rendered by the metrics registry
        as ingressnodefirewall_node_events_{lost,queued}_total)."""
        with self._lock:
            return {
                "events_lost_total": self.lost_samples,
                "events_queued_total": self.queued_total,
            }

    def __len__(self) -> int:
        with self._lock:
            return self._count


#: deny count above which a chunk's events travel as ONE BatchDenyRecord
#: (vectorized columns + binary spill) instead of per-event records with
#: raw-byte capture; below it the full reference line fidelity (src AND
#: dst decoded from the captured frame bytes) is kept.
BATCH_EMIT_THRESHOLD = 1024


def emit_deny_events(
    ring: EventRing,
    results: np.ndarray,
    ifindex: np.ndarray,
    pkt_len: np.ndarray,
    frames: Optional[Sequence[bytes]] = None,
    batch=None,
) -> int:
    """generate_event_and_update_statistics for a whole batch
    (kernel.c:361-399): one event per DENY verdict.

    Two regimes: small deny sets push per-event records capturing the
    first ≤MAX_EVENT_DATA frame bytes (full reference line format);
    replay-scale deny sets (> BATCH_EMIT_THRESHOLD, and ``batch`` —
    the parsed PacketBatch — provided) push one vectorized
    BatchDenyRecord so the pipeline keeps up with the classify rate
    instead of losing the majority of events.
    Returns the number of deny verdicts seen."""
    results = np.asarray(results)
    deny_idx = np.nonzero((results & 0xFF) == DENY)[0]
    if batch is not None and len(deny_idx) > BATCH_EMIT_THRESHOLD:
        ring.push_batch(BatchDenyRecord(
            ifindex=np.asarray(ifindex)[deny_idx],
            results=results[deny_idx].astype(np.uint32),
            pkt_len=np.asarray(pkt_len)[deny_idx],
            kind=np.asarray(batch.kind)[deny_idx],
            ip_words=np.asarray(batch.ip_words)[deny_idx].astype(np.uint32),
            proto=np.asarray(batch.proto)[deny_idx],
            dst_port=np.asarray(batch.dst_port)[deny_idx],
            icmp_type=np.asarray(batch.icmp_type)[deny_idx],
            icmp_code=np.asarray(batch.icmp_code)[deny_idx],
        ))
        return len(deny_idx)
    for pos, i in enumerate(deny_idx):
        if ring.is_full():
            # replay-scale fast path: a full ring loses the whole rest of
            # the batch in O(1) instead of constructing millions of
            # records just to drop them (the perf ring does the same —
            # overwritten slots surface only as LostSamples)
            ring.add_lost(len(deny_idx) - pos)
            break
        raw = bytes(frames[i][:MAX_EVENT_DATA]) if frames is not None else b""
        hdr = EventHdr(
            if_id=int(ifindex[i]),
            rule_id=get_rule_id(int(results[i])),
            action=get_action(int(results[i])),
            pkt_length=min(int(pkt_len[i]), 0xFFFF),
        )
        ring.push(EventRecord(hdr=hdr, packet=raw))
    return len(deny_idx)


def decode_event_lines(
    rec: EventRecord, iface_name: str = "?"
) -> List[str]:
    """The gopacket-equivalent decode (events.go:104-166): the exact line
    formats the reference writes to syslog, which the e2e suite regexes
    out of the sidecar logs (test/e2e/events/events.go:140-205)."""
    hdr = rec.hdr
    lines = [
        f"ruleId {hdr.rule_id} action {convert_xdp_action_to_string(hdr.action)} "
        f"len {hdr.pkt_length} if {iface_name}"
    ]
    pkt = rec.packet
    if len(pkt) < ETH_HLEN:
        return lines
    ethertype = struct.unpack_from("!H", pkt, 12)[0]
    l4_off = None
    proto = None
    if ethertype == ETH_P_IP and len(pkt) >= ETH_HLEN + IPV4_HLEN:
        src = ".".join(str(b) for b in pkt[ETH_HLEN + 12 : ETH_HLEN + 16])
        dst = ".".join(str(b) for b in pkt[ETH_HLEN + 16 : ETH_HLEN + 20])
        lines.append(f"\tipv4 src addr {src} dst addr {dst}")
        proto = pkt[ETH_HLEN + 9]
        l4_off = ETH_HLEN + IPV4_HLEN
    elif ethertype == ETH_P_IPV6 and len(pkt) >= ETH_HLEN + IPV6_HLEN:
        src = str(ipaddress.IPv6Address(pkt[ETH_HLEN + 8 : ETH_HLEN + 24]))
        dst = str(ipaddress.IPv6Address(pkt[ETH_HLEN + 24 : ETH_HLEN + 40]))
        lines.append(f"\tipv6 src addr {src} dst addr {dst}")
        proto = pkt[ETH_HLEN + 6]
        l4_off = ETH_HLEN + IPV6_HLEN
    if l4_off is None or proto is None:
        return lines
    hlen = _L4_HLEN.get(proto)
    if hlen is None or len(pkt) < l4_off + hlen:
        return lines
    if proto in (IPPROTO_TCP, IPPROTO_UDP, IPPROTO_SCTP):
        sport, dport = struct.unpack_from("!HH", pkt, l4_off)
        name = {IPPROTO_TCP: "tcp", IPPROTO_UDP: "udp", IPPROTO_SCTP: "sctp"}[proto]
        lines.append(f"\t{name} srcPort {sport} dstPort {dport}")
    elif proto == IPPROTO_ICMP:
        lines.append(f"\ticmpv4 type {pkt[l4_off]} code {pkt[l4_off + 1]}")
    elif proto == IPPROTO_ICMPV6:
        lines.append(f"\ticmpv6 type {pkt[l4_off]} code {pkt[l4_off + 1]}")
    return lines


class EventsLogger:
    """The daemon-side reader goroutine + syslog sidecar collapsed into a
    thread draining the ring into a line sink (stdout/logfile/collector).

    ``spill_path`` is the binary file replay-scale batches drain to;
    ``iface_names`` maps ifindex -> name (net.InterfaceByIndex,
    events.go:100-104); unknown indices log "?" rather than dropping the
    event (we keep the event; the reference skips it — kept intentionally
    so synthetic replays without a registry still record drops)."""

    def __init__(
        self,
        ring: EventRing,
        sink: Callable[[str], None],
        spill_path: str,
        iface_names: Optional[dict] = None,
        poll_interval_s: float = 0.05,
    ) -> None:
        self._ring = ring
        self._sink = sink
        self._iface_names = iface_names or {}
        self._interval = poll_interval_s
        # Binary spill for BatchDenyRecords: appending structured rows
        # (BatchDenyRecord.SPILL_DTYPE; 32 bytes, though the summary line
        # keeps the reference's "28B") keeps the drain at memory bandwidth
        # where per-line text formatting would fall behind the classify
        # rate; the line sink gets one summary line per batch.
        self._spill_path = spill_path
        self.spilled_total = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = spawn(self._run, name="infw-events-log")

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None
        self.drain_once()

    def drain_once(self) -> int:
        n = 0
        for rec in self._ring.pop_all():
            if isinstance(rec, BatchDenyRecord):
                n += self._drain_batch(rec)
                continue
            if isinstance(rec, EventRecord):
                name = self._iface_names.get(rec.hdr.if_id, "?")
                for line in decode_event_lines(rec, name):
                    self._sink(line)
                n += 1
                continue
            # line-record types render their own lines
            for line in rec.lines():
                self._sink(line)
            n += 1
        return n

    def _drain_batch(self, rec: BatchDenyRecord) -> int:
        k = len(rec)
        with open(self._spill_path, "ab") as f:
            rec.spill_rows().tofile(f)
        self.spilled_total += k
        self._sink(
            f"deny-event batch: {k} events spilled to "
            f"{self._spill_path} (binary, 28B/event)"
        )
        return k

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self.drain_once()
