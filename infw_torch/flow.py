"""The stateful flow tier: connection tracking on the card with an
exact-match fast path.

The counterpart of the JAX package's ``infw/flow.py``.  The dataplane's
verdict cache is a W-way set-associative hash table in fixed-shape device
tensors (kernels/flow.py FlowTable), probed BEFORE the LPM and the ordered
rule scan.  A hit serves the cached res16 verdict, with the flow's packet
and byte counters and its TCP state updated in the probe (kernel K7);
only the misses fall through to the stateless classify, compacted into a
power-of-two bucket, and their fresh verdicts are inserted back in one
launch (kernel K8).

A hit returns exactly what the stateless path would, for three reasons:

- the flow key covers every field the verdict depends on (tenant,
  ifindex, the 4 source-IP words, proto, dst_port, the ICMP type and
  code, kind, l4_ok); pkt_len only feeds statistics;
- entries carry the tenant's ruleset generation, a hit needs the current
  one, and every table mutation (patch, folded edit flush, full load,
  tenant swap or destroy) bumps it, with no sweep of the table;
- an insert stamps the generation captured at PROBE time, so a verdict
  computed against superseded tables is stale on arrival.

TCP model: non-TCP flows are established on their first insert; a TCP
flow whose first packet is a pure SYN is tracked as NEW, never served,
and promotes to EST on its next packet; FIN marks half-close (still
served); RST tears the entry down.  Without flags (0) every flow is
established on its first packet.

``HostFlowModel`` mirrors every device mutation bit for bit in numpy; a
tier built with ``track_model=True`` keeps one beside its columns.

Resident serving (the JAX package's ``resident_*``; the step itself is
kernels/resident.py, its pool ``infw_torch/resident.py``): one device
program per admission, K7, the stateless classify of every lane, the
merge and K8 under ``lane_ok = ~hit``.  The tier keeps a device epoch, a
(1,) int32 tensor that the step reads and advances in place (the port's
form of JAX's donated epoch), beside the host counter: both advance
together under the lock, +1 a step and +K a superbatch, and a classic
probe between resident dispatches (which moves the host counter only)
re-seeds the device epoch once.  The generation and page vectors reach
the step through two operand tensors the tier owns and refills from the
dispatch's snapshot, so a CUDA graph that baked their addresses serves
the generations of its turn.  With ``track_model`` the host model replays
each resident dispatch when its output is read, in epoch order.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from .constants import (
    FLOW_EMPTY,
    FLOW_EST,
    FLOW_FIN,
    FLOW_KEY_WORDS,
    FLOW_NEW,
    IPPROTO_ICMP,
    IPPROTO_ICMPV6,
    IPPROTO_TCP,
    KIND_IPV4,
    KIND_IPV6,
    TCP_ACK,
    TCP_FIN,
    TCP_RST,
    TCP_SYN,
)
from .kernels import flow as kflow
from .kernels.torchpath import host_to_device, resolve_device


def _pow2(n: int) -> int:
    return max(8, 1 << (max(int(n), 1) - 1).bit_length())


class FlowConfig(NamedTuple):
    """Geometry of one flow tier.  ``entries`` is PER SLAB (a power of two,
    for the mask-based double hashing); the table holds ``pages *
    entries`` rows.  A single-tenant classifier has one page; the arena's
    tier has one slab per arena page, steered by the same tenant page
    table that steers classification."""

    entries: int = 1 << 14
    pages: int = 1
    ways: int = 4
    max_tenants: int = 1
    #: entries last seen more than this many probes ago never serve and
    #: are the preferred eviction victims
    max_age: int = 1 << 20

    @staticmethod
    def make(entries: int = 1 << 14, pages: int = 1, ways: int = 4,
             max_tenants: int = 1, max_age: int = 1 << 20) -> "FlowConfig":
        if entries < 1 or pages < 1 or max_tenants < 1:
            raise ValueError("flow table entries, pages and max_tenants must be >= 1")
        if not 1 <= ways <= 8:
            raise ValueError(f"flow ways must be in [1, 8], got {ways}")
        if max_age < 1:
            raise ValueError(f"flow max_age must be >= 1, got {max_age}")
        return FlowConfig(entries=_pow2(entries), pages=int(pages), ways=int(ways),
                          max_tenants=int(max_tenants), max_age=int(max_age))

    @property
    def capacity(self) -> int:
        return self.entries * self.pages


class FlowStats:
    """Monotonic flow-tier counters (flow_* on /metrics)."""

    FIELDS = ("hits", "misses", "inserts", "evictions", "promotes",
              "stale_rejects", "invalidations", "aged", "age_sweeps")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        for f in self.FIELDS:
            setattr(self, f, 0)

    def add(self, **kw) -> None:
        with self._lock:
            for k, v in kw.items():
                setattr(self, k, getattr(self, k) + int(v))

    def values(self) -> Dict[str, int]:
        with self._lock:
            return {f: int(getattr(self, f)) for f in self.FIELDS}


# --- host mirrors of the device wire, key and hash ----------------------------


def host_unpack_wire(wire: np.ndarray) -> Dict[str, np.ndarray]:
    """Numpy mirror of torchpath.unpack_wire (widths 3, 4, 6 and 7): the
    host model reads exactly the fields the kernels see."""
    wire = np.asarray(wire, np.uint32)
    w0 = wire[:, 0]
    w1 = wire[:, 1]
    narrow = wire.shape[1] in (3, 6)
    ip_off = 2 if narrow else 3
    b = wire.shape[0]
    if wire.shape[1] in (3, 4):
        ip_words = np.zeros((b, 4), np.uint32)
        ip_words[:, 0] = wire[:, ip_off]
    else:
        ip_words = wire[:, ip_off: ip_off + 4].astype(np.uint32)
    proto = ((w0 >> 3) & 0xFF).astype(np.int32)
    if narrow:
        is_icmp = (proto == IPPROTO_ICMP) | (proto == IPPROTO_ICMPV6)
        l4w = (w1 & 0xFFFF).astype(np.int32)
        ifindex = ((w0 >> 11) & 0xFFFF).astype(np.int32)
        dst_port = np.where(is_icmp, 0, l4w)
        icmp_type = np.where(is_icmp, l4w >> 8, 0)
        icmp_code = np.where(is_icmp, l4w & 0xFF, 0)
        pkt_len = ((w1 >> 16) & 0xFFFF).astype(np.int32)
    else:
        ifindex = wire[:, 2].astype(np.int32)
        dst_port = (w1 & 0xFFFF).astype(np.int32)
        icmp_type = ((w0 >> 11) & 0xFF).astype(np.int32)
        icmp_code = ((w0 >> 19) & 0xFF).astype(np.int32)
        pkt_len = (((w1 >> 16) & 0xFFFF) | ((w0 >> 27) << 16)).astype(np.int32)
    return {
        "kind": (w0 & 3).astype(np.int32),
        "l4_ok": ((w0 >> 2) & 1).astype(np.int32),
        "ifindex": ifindex,
        "ip_words": ip_words,
        "proto": proto,
        "dst_port": dst_port,
        "icmp_type": icmp_type,
        "icmp_code": icmp_code,
        "pkt_len": pkt_len,
    }


def host_flow_key_words(f: Dict[str, np.ndarray], tenant: np.ndarray) -> np.ndarray:
    m0 = (
        (f["proto"].astype(np.uint32) & 0xFF)
        | ((f["dst_port"].astype(np.uint32) & 0xFFFF) << 8)
        | ((f["kind"].astype(np.uint32) & 3) << 24)
        | ((f["l4_ok"].astype(np.uint32) & 1) << 26)
    )
    m1 = (f["icmp_type"].astype(np.uint32) & 0xFF) | (
        (f["icmp_code"].astype(np.uint32) & 0xFF) << 8
    )
    return np.stack(
        [tenant.astype(np.uint32), f["ifindex"].astype(np.uint32), f["ip_words"][:, 0],
         f["ip_words"][:, 1], f["ip_words"][:, 2], f["ip_words"][:, 3], m0, m1],
        axis=1,
    )


def host_flow_hash(keys: np.ndarray):
    h = np.full(keys.shape[0], 0x811C9DC5, np.uint32)
    for w in range(FLOW_KEY_WORDS):
        h = (h ^ keys[:, w].astype(np.uint32)) * np.uint32(0x01000193)
    return h, (h >> np.uint32(16)) | np.uint32(1)


def host_flow_slots(keys: np.ndarray, page: np.ndarray, *, slab_entries: int,
                    ways: int) -> np.ndarray:
    h1, h2 = host_flow_hash(keys)
    w = np.arange(ways, dtype=np.uint32)[None, :]
    local = (h1[:, None] + w * h2[:, None]) & np.uint32(slab_entries - 1)
    return np.clip(page, 0, None)[:, None] * slab_entries + local.astype(np.int32)


class HostFlowModel:
    """Bit-exact numpy mirror of the device flow table: the same key and
    hash forms, way choice and winner rule, and the same add/max/min and
    per-slot-unique set semantics."""

    def __init__(self, config: FlowConfig) -> None:
        self.config = config
        C = config.capacity
        self.keys = np.zeros((C, FLOW_KEY_WORDS), np.uint32)
        self.vg = np.zeros((C, 2), np.int32)   # [verdict, gen]
        self.se = np.zeros((C, 2), np.int32)   # [state, epoch]
        self.cnt = np.zeros((C, 3), np.int32)  # [pkts, bhi, blo]
        self.gens = np.zeros(config.max_tenants, np.int32)
        self.page_table = np.full(config.max_tenants, -1, np.int32)
        if config.pages == 1 and config.max_tenants == 1:
            self.page_table[0] = 0

    def columns(self) -> Dict[str, np.ndarray]:
        return {"keys": self.keys, "vg": self.vg, "se": self.se, "cnt": self.cnt}

    def _lanes(self, wire, tenant, tflags):
        f = host_unpack_wire(wire)
        b = wire.shape[0]
        tenant = np.zeros(b, np.int32) if tenant is None else np.asarray(tenant, np.int32)
        tflags = np.zeros(b, np.int32) if tflags is None else np.asarray(tflags, np.int32)
        mt = self.config.max_tenants
        t_ok = (tenant >= 0) & (tenant < mt)
        page = np.where(t_ok, self.page_table[np.clip(tenant, 0, mt - 1)], -1)
        keyw = host_flow_key_words(f, tenant)
        is_ip = (f["kind"] == KIND_IPV4) | (f["kind"] == KIND_IPV6)
        cand = host_flow_slots(keyw, page, slab_entries=self.config.entries,
                               ways=self.config.ways)
        return f, tenant, tflags, page, keyw, is_ip, cand

    def probe(self, wire, tenant, tflags, epoch_now: int):
        """Mirror of kernels.flow.flow_probe_plain -> (res16, hit mask,
        hits, stale); mutates counters, epochs and states like the card."""
        cfg = self.config
        f, tenant, tflags, page, keyw, is_ip, cand = self._lanes(wire, tenant, tflags)
        elig = is_ip & (f["l4_ok"] != 0) & (page >= 0)
        ek = self.keys[cand]
        ese = self.se[cand]
        evg = self.vg[cand]
        match = np.all(ek == keyw[:, None, :], axis=2) & elig[:, None]
        live = ese[:, :, 0] >= FLOW_EST
        mygen = self.gens[np.clip(tenant, 0, cfg.max_tenants - 1)]
        gen_ok = evg[:, :, 1] == mygen[:, None]
        with np.errstate(over="ignore"):
            fresh = (np.int32(epoch_now) - ese[:, :, 1]) <= cfg.max_age
        hit_w = match & live & gen_ok & fresh
        stale_w = match & live & fresh & ~gen_ok
        W = cfg.ways
        widx = np.arange(W, dtype=np.int32)[None, :]
        first = np.min(np.where(hit_w, widx, W), axis=1)
        hit = first < W
        sel = np.sum(np.where(widx == first[:, None], cand, 0), axis=1)
        stale = np.any(stale_w, axis=1) & ~hit
        res16 = np.where(
            hit, np.sum(np.where(widx == first[:, None], evg[:, :, 0], 0), axis=1), 0,
        ).astype(np.uint16)
        hs = sel[hit]
        ln = f["pkt_len"]
        upd = np.stack([np.ones_like(ln), (ln >> 8) & 0xFFFFFF, ln & 0xFF], axis=1)
        np.add.at(self.cnt, hs, upd[hit])
        is_tcp = f["proto"] == IPPROTO_TCP
        fin = is_tcp & ((tflags & TCP_FIN) != 0)
        rst = is_tcp & ((tflags & TCP_RST) != 0)
        big = np.int32(np.iinfo(np.int32).max)
        mx = np.stack([np.where(hit & fin, FLOW_FIN, -1).astype(np.int32),
                       np.full(len(hit), epoch_now, np.int32)], axis=1)
        np.maximum.at(self.se, hs, mx[hit])
        mn = np.stack([np.full(len(hit), FLOW_EMPTY, np.int32),
                       np.full(len(hit), big, np.int32)], axis=1)
        np.minimum.at(self.se, sel[hit & rst], mn[hit & rst])
        return res16, hit, int(hit.sum()), int(stale.sum())

    def insert(self, wire, tenant, tflags, verdict16, epoch_now: int,
               gens: Optional[np.ndarray] = None, lane_ok: Optional[np.ndarray] = None):
        """Mirror of kernels.flow.flow_insert_plain -> (inserts, evictions,
        promotes).  ``gens`` overrides the generation stamp source (the tier
        passes its probe-time snapshot); ``lane_ok`` (B,) bool is the
        resident step's in-program miss mask (the same eligible lanes, in
        the same order, as the host's compaction of the misses)."""
        cfg = self.config
        f, tenant, tflags, page, keyw, is_ip, cand = self._lanes(wire, tenant, tflags)
        if gens is None:
            gens = self.gens
        is_tcp = f["proto"] == IPPROTO_TCP
        syn = is_tcp & ((tflags & TCP_SYN) != 0)
        ack = is_tcp & ((tflags & TCP_ACK) != 0)
        fin = is_tcp & ((tflags & TCP_FIN) != 0)
        rst = is_tcp & ((tflags & TCP_RST) != 0)
        elig = is_ip & (f["l4_ok"] != 0) & (page >= 0) & ~rst
        if lane_ok is not None:
            elig = elig & np.asarray(lane_ok, bool)
        ek = self.keys[cand]
        ese = self.se[cand]
        est = ese[:, :, 0]
        eep = ese[:, :, 1]
        match_w = np.all(ek == keyw[:, None, :], axis=2) & (est > 0)
        empty_w = est == 0
        W = cfg.ways
        widx = np.arange(W, dtype=np.int32)[None, :]
        m_first = np.min(np.where(match_w, widx, W), axis=1)
        e_first = np.min(np.where(empty_w, widx, W), axis=1)
        oldest = np.argmin(eep, axis=1).astype(np.int32)
        way = np.where(m_first < W, m_first, np.where(e_first < W, e_first, oldest))
        slot = np.sum(np.where(widx == way[:, None], cand, 0), axis=1)
        matched = m_first < W
        old_state = np.sum(np.where(widx == way[:, None], est, 0), axis=1)
        C = cfg.capacity
        lane = np.arange(slot.shape[0], dtype=np.int32)
        winner = np.full(C + 1, -1, np.int32)
        np.maximum.at(winner, np.where(elig, slot, C), lane)
        win = elig & (winner[np.clip(slot, 0, C)] == lane)
        ln = f["pkt_len"]
        seeds = np.zeros((C, 3), np.int32)
        np.add.at(seeds, slot[elig],
                  np.stack([np.ones_like(ln), (ln >> 8) & 0xFFFFFF, ln & 0xFF], axis=1)[elig])
        state_val = np.where(
            fin, FLOW_FIN, np.where(is_tcp & syn & ~ack, FLOW_NEW, FLOW_EST)
        ).astype(np.int32)
        mygen = gens[np.clip(tenant, 0, cfg.max_tenants - 1)]
        ws = slot[win]
        self.keys[ws] = keyw[win]
        self.vg[ws, 0] = (np.asarray(verdict16, np.int64)[win] & 0xFFFF).astype(np.int32)
        self.vg[ws, 1] = mygen[win]
        self.se[ws, 0] = state_val[win]
        self.se[ws, 1] = np.int32(epoch_now)
        self.cnt[ws] = seeds[ws]
        evict = win & ~matched & (old_state > 0)
        promote = win & matched & (old_state == FLOW_NEW) & (state_val == FLOW_EST)
        return int(win.sum()), int(evict.sum()), int(promote.sum())

    def age(self, cutoff: int) -> int:
        expire = (self.se[:, 0] > 0) & (self.se[:, 1] < cutoff)
        self.se[expire, 0] = FLOW_EMPTY
        return int(expire.sum())

    def occupancy(self) -> int:
        return int((self.se[:, 0] > 0).sum())


# --- the device tier -------------------------------------------------------------


class FlowTier:
    """Host-side owner of the flow table on one device: the launches of
    K7 and K8, the per-tenant generations and flow pages, the counters,
    and (opt-in) the shadow HostFlowModel.

    The columns are updated in place, in launch order, under the tier's
    lock; a launch from a stream other than the previous one's first waits
    on that launch's event, so the table sees one sequence of probes and
    inserts, as the JAX tier's chain of functional updates does.  The
    generation and page vectors are replaced, never written, so a probe's
    snapshot of them (the ``ctx`` its insert stamps with) stays what it
    was."""

    def __init__(self, config: FlowConfig, device=None, track_model: bool = False) -> None:
        self.config = config
        self._device = resolve_device(device)
        self._lock = threading.Lock()
        self.stats = FlowStats()
        #: optional sink for eviction events: on_evict(evictions, inserts,
        #: epoch) after an insert that displaced live flows (the daemon
        #: pushes a FlowEvictRecord on its event ring)
        self.on_evict: Optional[Callable] = None
        self._flow = kflow.empty_flow_table(config.capacity, self._device)
        self._gens_host = np.zeros(config.max_tenants, np.int32)
        self._pages_host = np.full(config.max_tenants, -1, np.int32)
        if config.pages == 1 and config.max_tenants == 1:
            self._pages_host[0] = 0  # the single-tenant tier: tenant 0 owns the slab
        self._gens_dev = self._put(self._gens_host)
        self._pages_dev = self._put(self._pages_host)
        self._epoch = 0
        # per-B zero tenant and flags columns, so the common dispatch
        # uploads neither
        self._zeros_cache: Dict[int, tuple] = {}
        self._zeros_lock = threading.Lock()
        # (event, stream) of the last launch on a card
        self._last = None
        # resident serving: the device epoch (made at the first resident
        # dispatch) and the host value it holds once the queued steps ran,
        # the step's generation and page operands and the snapshots they
        # were last filled from, the model's queue of resident dispatches
        # to replay (track_model only)
        self._epoch_dev: Optional[torch.Tensor] = None
        self._epoch_dev_val = -1
        self._res_ops = None
        self._res_src = (None, None)
        self._mirror_q: list = []
        self.model = HostFlowModel(config) if track_model else None

    @property
    def device(self) -> torch.device:
        return self._device

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return host_to_device(np.ascontiguousarray(a).view(np.int32), self._device)

    def _zeros(self, b: int):
        """The zero tenant and flags columns of ``b`` lanes (or (k, b) for a
        superbatch), made once per shape and kept for the tier's life: a CUDA
        graph bakes their address.  Made under a lock of their own by a
        blocking copy, so every thread gets the same pair and every stream
        reads the zeros."""
        with self._zeros_lock:
            z = self._zeros_cache.get(b)
            if z is None:
                zero = np.zeros(b if isinstance(b, int) else tuple(b), np.int32)
                z = (self._put(zero), self._put(zero))
                self._zeros_cache[b] = z
            return z

    def _columns(self, b: int, tenant_np, tflags_np):
        zt, zf = self._zeros(b)
        tenant = zt if tenant_np is None else self._put(np.asarray(tenant_np, np.int32))
        tflags = zf if tflags_np is None else self._put(np.asarray(tflags_np, np.int32))
        return tenant, tflags

    def _ordered(self):
        """Under the lock, before a launch: order it after the previous
        launch when that ran on another stream.  Returns the stream to
        record on after the launch (None off the card)."""
        if self._device.type != "cuda":
            return None
        cur = torch.cuda.current_stream(self._device)
        if self._last is not None and self._last[1] != cur:
            cur.wait_event(self._last[0])
        return cur

    def _record(self, stream) -> None:
        if stream is not None:
            ev = torch.cuda.Event()
            ev.record(stream)
            self._last = (ev, stream)

    # -- generation / paging ----------------------------------------------------

    def bump_generation(self, tenant: int = 0) -> None:
        """Invalidate every cached verdict of ``tenant`` (O(1): entries go
        stale by the generation compare).  Called at every table-mutation
        chokepoint: load_tables and the arena's tenant lifecycle."""
        with self._lock:
            if not 0 <= tenant < self.config.max_tenants:
                return
            self._gens_host[tenant] += 1
            self._gens_dev = self._put(self._gens_host)
            if self.model is not None:
                self.model.gens[tenant] += 1
        self.stats.add(invalidations=1)

    def bump_all_generations(self) -> None:
        with self._lock:
            self._gens_host += 1
            self._gens_dev = self._put(self._gens_host)
            if self.model is not None:
                self.model.gens += 1
        self.stats.add(invalidations=1)

    def set_page(self, tenant: int, page: int) -> None:
        """Steer ``tenant``'s flow slab (the arena mirrors its page table
        here; -1 unmaps).  Callers pair it with a generation bump, and the
        key's tenant word keeps tenants apart even without one."""
        with self._lock:
            if not 0 <= tenant < self.config.max_tenants:
                return
            self._pages_host[tenant] = int(page) % self.config.pages if page >= 0 else -1
            self._pages_dev = self._put(self._pages_host)
            if self.model is not None:
                self.model.page_table[:] = self._pages_host

    # -- probe / insert -------------------------------------------------------------

    def probe(self, wire_np: np.ndarray, tenant_np: Optional[np.ndarray] = None,
              tflags_np: Optional[np.ndarray] = None):
        """Launch K7 on one (B, 4 | 7) wire batch.  Returns (fused device
        buffer, ctx): the buffer decodes with split_flow_probe_outputs;
        ``ctx`` carries the probe-time epoch, generations and pages that
        the matching insert stamps with."""
        b = wire_np.shape[0]
        wire = self._put(np.asarray(wire_np, np.uint32))
        tenant, tflags = self._columns(b, tenant_np, tflags_np)
        cfg = self.config
        with self._lock:
            self._epoch += 1
            epoch = self._epoch
            gens_dev, pages_dev = self._gens_dev, self._pages_dev
            stream = self._ordered()
            fused = kflow.flow_probe(self._flow, gens_dev, pages_dev, wire, tenant, tflags, epoch,
                                     cfg.max_age, slab_entries=cfg.entries, ways=cfg.ways)
            self._record(stream)
            if self.model is not None:
                self.model.probe(wire_np, tenant_np, tflags_np, epoch)
            gens_host = self._gens_host.copy()
        return fused, {"epoch": epoch, "gens_dev": gens_dev, "pages_dev": pages_dev,
                       "gens_host": gens_host}

    def insert(self, ctx, miss_wire_np: np.ndarray, verdict16: np.ndarray,
               tenant_np: Optional[np.ndarray] = None,
               tflags_np: Optional[np.ndarray] = None) -> tuple:
        """Launch K8 on the miss verdicts, stamped with the probe-time
        generations of ``ctx``.  Returns (inserts, evictions, promotes)."""
        b = miss_wire_np.shape[0]
        wire = self._put(np.asarray(miss_wire_np, np.uint32))
        tenant, tflags = self._columns(b, tenant_np, tflags_np)
        verdict = self._put(np.asarray(verdict16, np.uint32))
        cfg = self.config
        with self._lock:
            stream = self._ordered()
            counts = kflow.flow_insert(self._flow, ctx["gens_dev"], ctx["pages_dev"], wire,
                                       tenant, tflags, verdict, ctx["epoch"],
                                       slab_entries=cfg.entries, ways=cfg.ways)
            self._record(stream)
            if self.model is not None:
                self.model.insert(miss_wire_np, tenant_np, tflags_np, verdict16, ctx["epoch"],
                                  gens=ctx["gens_host"])
        c = counts.cpu().numpy()
        inserts, evictions, promotes = int(c[0]), int(c[1]), int(c[2])
        self.stats.add(inserts=inserts, evictions=evictions, promotes=promotes)
        if evictions and self.on_evict is not None:
            try:
                self.on_evict(evictions, inserts, ctx["epoch"])
            except Exception:
                pass
        return inserts, evictions, promotes

    # -- upkeep ---------------------------------------------------------------------

    def age(self, horizon: Optional[int] = None) -> int:
        """Free every entry last seen more than ``horizon`` probes ago
        (default: the configured max_age).  Stale entries never serve
        anyway; the sweep returns their slots ahead of LRU pressure."""
        h = int(horizon if horizon is not None else self.config.max_age)
        with self._lock:
            cutoff = self._epoch - h
            stream = self._ordered()
            aged = kflow.flow_age(self._flow.se, cutoff)
            self._record(stream)
            if self.model is not None:
                self.model.age(cutoff)
        aged = int(aged)
        self.stats.add(aged=aged, age_sweeps=1)
        return aged

    def reset(self) -> None:
        """Drop every flow (the columns zeroed in place, so a CUDA graph of
        the resident step keeps its addresses); generations and pages
        stay."""
        with self._lock:
            stream = self._ordered()
            for name in kflow.COLUMNS:
                getattr(self._flow, name).zero_()
            self._record(stream)
            if self.model is not None:
                m = HostFlowModel(self.config)
                m.gens = self.model.gens
                m.page_table = self.model.page_table
                self.model = m

    def occupancy(self) -> int:
        with self._lock:
            self._ordered()
            return int(kflow.flow_occupancy(self._flow.se))

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    # -- resident serving (the resident step, kernels/resident.py) -------------------

    def resident_gens_snapshot(self):
        """(generation tensor, host copy) under the lock.  The resident plan
        takes it BEFORE it snapshots the tables, so a load_tables between
        the two can only make the stamped generation older than the tables
        that compute the verdicts (their inserts are stale on arrival)."""
        with self._lock:
            return self._gens_dev, self._gens_host.copy()

    def _resident_operands(self, gens_src):
        """Under the lock: the step's generation and page operands, refilled
        (a copy on the current stream) from ``gens_src`` and the tier's
        page vector when either is another tensor than last time."""
        if self._res_ops is None:
            self._res_ops = (torch.empty_like(self._gens_dev), torch.empty_like(self._pages_dev))
        gens_op, pages_op = self._res_ops
        if self._res_src[0] is not gens_src:
            gens_op.copy_(gens_src)
        if self._res_src[1] is not self._pages_dev:
            pages_op.copy_(self._pages_dev)
        self._res_src = (gens_src, self._pages_dev)
        return gens_op, pages_op

    def _resident_epoch(self, epoch0: int, alloc_note) -> torch.Tensor:
        """Under the lock: the device epoch holding ``epoch0`` when the
        dispatch's steps run.  It is made at the first resident dispatch and
        re-seeded in place when a classic probe moved the host counter since
        the last resident one (one small copy, counted by ``alloc_note`` as
        the JAX package counts its re-seed upload)."""
        if self._epoch_dev is None or self._epoch_dev_val != epoch0:
            if self._epoch_dev is None:
                self._epoch_dev = torch.empty(1, dtype=torch.int32, device=self._device)
            self._epoch_dev.fill_(wrap_epoch(epoch0))
            if alloc_note is not None:
                alloc_note()
        return self._epoch_dev

    def _zeros_noted(self, key, alloc_note):
        with self._zeros_lock:
            fresh = key not in self._zeros_cache
        if fresh and alloc_note is not None:
            alloc_note()
        return self._zeros(key)

    def resident_dispatch(self, launch, b: int, wire_np: Optional[np.ndarray] = None,
                          tenant=None, tflags=None, tenant_np: Optional[np.ndarray] = None,
                          tflags_np: Optional[np.ndarray] = None, gens_snap=None,
                          alloc_note=None, k: int = 0, telemetry=None, mlscore=None,
                          payload=None):
        """Run one resident step (``k`` = 0) or a superbatch of ``k`` steps
        (flow.py resident_dispatch and resident_dispatch_super).  Under the
        lock the host epoch advances by one step each, the device epoch is
        chained or re-seeded, and ``launch(ResidentOps)`` enqueues the work
        on the current stream; it returns the dispatch's output handle
        (``.host()`` gives the fused words, (L,) or (k, L)).  ``tenant`` and
        ``tflags`` are device columns ((b,) or (k, b)), None for the tier's
        zero columns; ``tenant_np`` / ``tflags_np`` feed the model's
        mirror.  With ``telemetry`` (an obs.telemetry.TelemetryTier) the
        launch runs inside its exchange, under its lock taken inside this
        tier's (the one nesting order), with the plane's operands in
        ``ResidentOps.sketch``; with ``mlscore`` (an mlscore.AnomalyTier)
        the same inside the telemetry tier's exchange (flow -> telemetry ->
        mlscore), with its operands in ``ResidentOps.score``; with
        ``payload`` (a payload.PayloadTier, the device column and lengths)
        the same innermost (flow -> telemetry -> mlscore -> payload), with
        its operands in ``ResidentOps.payload``.  Returns (handle, last
        epoch)."""
        steps = max(int(k), 1)
        key = (k, b) if k else b
        if tenant is None:
            tenant = self._zeros_noted(key, alloc_note)[0]
        if tflags is None:
            tflags = self._zeros_noted(key, alloc_note)[1]
        with self._lock:
            epoch0 = self._epoch
            self._epoch += steps
            epoch = self._epoch
            # the re-seed and the operand refills write buffers that the
            # previous launch may still read: order them after it
            stream = self._ordered()
            epoch_dev = self._resident_epoch(epoch0, alloc_note)
            gens_src = self._gens_dev if gens_snap is None else gens_snap[0]
            gens_op, pages_op = self._resident_operands(gens_src)
            ops = ResidentOps(self._flow, gens_op, pages_op, epoch_dev, tenant, tflags,
                              self.config.max_age, self.config.entries, self.config.ways)
            run = launch
            if payload is not None:
                ptier, pay, plen = payload

                def run(o, inner=run):
                    return ptier.resident_exchange(
                        lambda po: inner(o._replace(payload=po)), pay, plen)
            if mlscore is not None:
                # the scoring tier's lock nests inside the telemetry tier's
                def run(o, inner=run):
                    return mlscore.resident_exchange(
                        lambda sc: inner(o._replace(score=sc)), wire_np, tenant_np, tflags_np,
                        k=k)
            if telemetry is None:
                handle = run(ops)
            else:
                handle = telemetry.resident_exchange(
                    lambda sk: run(ops._replace(sketch=sk)), wire_np, tenant_np, tflags_np,
                    k=k)
            self._record(stream)
            self._epoch_dev_val = epoch
            if self.model is not None:
                gens_host = self._gens_host.copy() if gens_snap is None else gens_snap[1]
                wires = np.asarray(wire_np, np.uint32)
                for j in range(steps):
                    pick = (lambda a: None if a is None else np.asarray(
                        a[j] if k else a, np.int32).copy())
                    self._mirror_q.append((epoch0 + 1 + j, (wires[j] if k else wires).copy(),
                                           pick(tenant_np), pick(tflags_np),
                                           (handle, j if k else None), gens_host))
        return handle, epoch

    def resident_seed_epoch(self) -> None:
        """Bring the device epoch to the host counter (the JAX package's
        re-seed at warm-mark time: the classic warm moved the host counter
        only, and the first serving dispatch must not pay the re-seed)."""
        with self._lock:
            if self._epoch_dev_val != self._epoch:
                stream = self._ordered()
                self._resident_epoch(self._epoch, None)
                self._record(stream)
                self._epoch_dev_val = self._epoch

    def resident_note_materialized(self, epoch: int) -> None:
        """Replay the queued resident dispatches up to ``epoch`` into the
        host model, in epoch order (track_model only): a dispatch's insert
        needs its merged verdicts, on the host only once it is read, so a
        result read out of order still replays in device order."""
        if self.model is None:
            return
        from .kernels.resident import split_resident_outputs

        with self._lock:
            while self._mirror_q and self._mirror_q[0][0] <= epoch:
                ep, wire_np, tenant_np, tflags_np, (handle, row), gens_host = \
                    self._mirror_q.pop(0)
                arr = handle.host()
                res16, hit, _h, _s, _c = split_resident_outputs(
                    arr if row is None else arr[row], wire_np.shape[0])
                self.model.probe(wire_np, tenant_np, tflags_np, ep)
                self.model.insert(wire_np, tenant_np, tflags_np, res16, ep, gens=gens_host,
                                  lane_ok=~hit)

    def flow_columns(self) -> Dict[str, np.ndarray]:
        """Host copies of the four columns (``keys`` as uint32)."""
        with self._lock:
            self._ordered()
            out = {k: getattr(self._flow, k).cpu().numpy() for k in kflow.COLUMNS}
        out["keys"] = out["keys"].view(np.uint32)
        return out

    def counter_values(self) -> Dict[str, int]:
        """flow_* counters and the occupancy and capacity gauges."""
        out = {f"flow_{k}_total": v for k, v in self.stats.values().items()}
        out["flow_occupancy"] = self.occupancy()
        out["flow_capacity"] = self.config.capacity
        return out

    def warm(self, ladder) -> int:
        """Run one probe and one insert of inert KIND_OTHER rows (never
        eligible, so the table is untouched) at every size of ``ladder``
        and every power of two from 8 below its largest, on the 4- and
        7-word wires; on the card the first one builds K7 and K8.  Returns
        the launches made."""
        ladder = sorted(set(int(b) for b in ladder))
        if ladder:
            b = 8
            extra = []
            while b < ladder[-1]:
                extra.append(b)
                b <<= 1
            ladder = sorted(set(ladder) | set(extra))
        n = 0
        for b in ladder:
            for width in (4, 7):
                wire = np.zeros((int(b), width), np.uint32)
                wire[:, 0] = 3  # KIND_OTHER: ineligible everywhere
                fused, ctx = self.probe(wire)
                fused.cpu()
                self.insert(ctx, wire, np.zeros(int(b), np.uint16))
                n += 2
        return n


class ResidentOps(NamedTuple):
    """What a resident launch gets from the tier: the columns, the
    generation and page operands, the device epoch, the tenant and flag
    columns, and the geometry."""

    flow: kflow.FlowTable
    gens: torch.Tensor
    pages: torch.Tensor
    epoch_dev: torch.Tensor
    tenant: torch.Tensor
    tflags: torch.Tensor
    max_age: int
    slab_entries: int
    ways: int
    #: the telemetry plane's obs.telemetry.SketchOps (None when off)
    sketch: object = None
    #: the scoring tier's kernels.mxu_score.ScoreOps (None when off)
    score: object = None
    #: the payload tier's kernels.acmatch.PayloadOps with the admission's
    #: column (None when off or the admission carries none)
    payload: object = None


def wrap_epoch(e: int) -> int:
    """A host epoch as the int32 the device holds."""
    return int(np.int64(e).astype(np.int32))


def flow_miss_bucket(m: int) -> int:
    """Power-of-two padding bucket of the compacted miss batch."""
    return _pow2(m)
