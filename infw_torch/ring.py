"""The persistent ingest ring: one shared-memory file through which a
producer (``python -m infw_torch.tools.loadgen --ring``) hands the daemon
packed-wire records.

The counterpart of the JAX package's ``infw/ring.py``, with the same file
layout byte for byte, so a producer of either package feeds a consumer of
the other.  The producer writes each record IN PLACE into a mapped slot (no
per-record file create, rename or unlink, no per-record allocation),
publishes it with one commit-word store, and the consumer pops it as
numpy views over the mapping.

On a CUDA card the daemon turns on ``stage_pinned``: ``pop`` then copies
each record once, on the host, into a page-locked buffer of its slot and
returns views over that buffer, so every copy that reads a record onto the
card is a pinned copy.  Registering the mapping itself as page-locked
memory (cudaHostRegister) fails on some filesystems (a v9fs mount refuses
it with cudaErrorInvalidValue), and the ring's path is the operator's
choice, so the daemon does not depend on it.  Slots are released only
after the dispatch that read them materialized, as in the JAX package, so
a buffer is never refilled under a copy.

Layout (one file, mapped by both sides):

- a 4096-byte header page: magic ``INFWRNG1``, then (version << 32 |
  slots), slot_bytes, the producer's ``head`` and the consumer's ``tail``
  cursor (uint64 sequence numbers that only grow, each written by one
  side);
- ``slots`` slots of ``slot_bytes`` each, a multiple of 64 bytes.  A slot
  is: commit (u64, sequence + 1 once everything below it is written: the
  publish point), n (u32 packets), width (u32, 4 or 7), flags (u32: bit 0
  v4_only, bit 1 TCP flags present, bit 2 payload column present), the
  payload prefix width L (u32, 0 without the column), padding to 64
  bytes, then ``n * width`` uint32 wire words, then ``n`` int32 TCP flags
  when present, then the optional payload column: ``n * L`` uint8 bytes
  and ``n`` int32 lengths.  L is one of
  ``kernels.wire_decode.PAYLOAD_PREFIX_WIDTHS`` (64, 128).

One producer and one consumer: the commit word gives the consumer a
publish point with no torn reads and no lock.  A full ring blocks the
producer, up to its ``timeout``; it never drops (dropping belongs to the
NIC edge, where the reference XDP program counts it).
"""
from __future__ import annotations

import mmap
import os
import time
from typing import Optional

import numpy as np

from .kernels.wire_decode import PAYLOAD_PREFIX_WIDTHS

_MAGIC = b"INFWRNG1"
_VERSION = 1
_HEADER_BYTES = 4096
_SLOT_HEADER_BYTES = 64

#: record flag bits
FLAG_V4_ONLY = 1
FLAG_TCP_FLAGS = 2
FLAG_PAYLOAD = 4

DEFAULT_SLOTS = 64
DEFAULT_SLOT_PACKETS = 4096


def slot_bytes_for(max_packets: int, width: int = 7, with_flags: bool = True,
                   payload_width: int = 0) -> int:
    """The slot size that fits ``max_packets`` of the widest record shape;
    ``payload_width`` > 0 reserves the payload column (L bytes and one
    int32 length a packet)."""
    n = _SLOT_HEADER_BYTES + max_packets * width * 4
    if with_flags:
        n += max_packets * 4
    if payload_width:
        n += max_packets * (int(payload_width) + 4)
    return (n + 63) & ~63


class RingChunk:
    """One popped record: numpy views over the mapped slot (or its staged
    copy), valid until ``release()``; hold the chunk until the dispatch that
    read it has materialized, or copy."""

    __slots__ = ("wire", "tcp_flags", "payload", "payload_len", "v4_only", "seq", "_ring")

    def __init__(self, ring, seq, wire, tcp_flags, v4_only, payload=None, payload_len=None):
        self._ring = ring
        self.seq = seq
        self.wire = wire
        self.tcp_flags = tcp_flags
        self.v4_only = v4_only
        #: the payload column, (n, L) uint8 and (n,) int32 views, or None
        self.payload = payload
        self.payload_len = payload_len

    def release(self) -> None:
        """Return the slot to the producer (the tail moves past ``seq``).
        Records release in pop order; the ring refuses any other order."""
        if self._ring is not None:
            ring, self._ring = self._ring, None
            ring._advance_tail(self.seq)


class IngestRing:
    """The mapped ring.  ``create`` makes and initializes the file (the
    consumer, which owns the sizing); ``attach`` maps an existing one (the
    producer) and checks its header."""

    def __init__(self, path: str, mm: mmap.mmap, create: bool, slots: int,
                 slot_bytes: int) -> None:
        self.path = path
        self._mm = mm
        self.slots = int(slots)
        self.slot_bytes = int(slot_bytes)
        self._u64 = np.frombuffer(mm, np.uint64, 6, 0)
        # each side of the pair attaches its own instance, and each key is
        # written by one side only: pushed, blocked_waits, blocked_us and
        # depth_hwm_prod by the producer, popped and depth_hwm_cons by the
        # consumer; counter_values merges the two watermarks.  blocked_us is
        # the wall time reserve() waited on a full ring: the producer's
        # backpressure signal
        self._stats = {"pushed": 0, "popped": 0, "blocked_waits": 0, "depth_hwm_prod": 0,
                       "depth_hwm_cons": 0, "blocked_us": 0}
        # the consumer's read cursor: records between the tail and here are
        # popped but not released (their views may be in flight), and the
        # producer reuses only slots behind the tail
        self._read_seq = int(self._u64[4])
        # corrupt records pop() skipped: their slots free only when the
        # release order reaches them (_drain_skipped), so a bad record never
        # moves the tail past earlier records still in flight
        self._skipped: set = set()
        # stage_pinned's per-slot host buffers (None: pop returns views over
        # the mapping) and their allocator
        self._stage: Optional[list] = None
        self._stage_alloc = None

    # -- lifecycle -----------------------------------------------------------

    @classmethod
    def create(cls, path: str, slots: int = DEFAULT_SLOTS,
               slot_packets: int = DEFAULT_SLOT_PACKETS,
               payload_width: int = 0) -> "IngestRing":
        # built under a temporary name and renamed into place, so a
        # producer's attach (which retries until the path exists) never
        # maps a half-initialized file
        slot_b = slot_bytes_for(slot_packets, payload_width=payload_width)
        total = _HEADER_BYTES + slots * slot_b
        tmp = f"{path}.tmp.{os.getpid()}"
        fd = os.open(tmp, os.O_CREAT | os.O_RDWR | os.O_TRUNC, 0o600)
        try:
            os.ftruncate(fd, total)
            mm = mmap.mmap(fd, total)
        finally:
            os.close(fd)
        hdr = np.frombuffer(mm, np.uint64, 6, 0)
        hdr[1] = (_VERSION << 32) | slots
        hdr[2] = slot_b
        hdr[3] = 0  # head
        hdr[4] = 0  # tail
        for i in range(slots):  # no stale publish survives
            np.frombuffer(mm, np.uint64, 1, _HEADER_BYTES + i * slot_b)[0] = 0
        mm[0:8] = _MAGIC  # the magic last: a torn file never validates
        mm.flush()
        os.replace(tmp, path)
        return cls(path, mm, True, slots, slot_b)

    @classmethod
    def attach(cls, path: str, timeout: float = 5.0) -> "IngestRing":
        deadline = time.monotonic() + timeout
        while True:
            try:
                fd = os.open(path, os.O_RDWR)
            except FileNotFoundError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.01)
                continue
            try:
                size = os.fstat(fd).st_size
                if size < _HEADER_BYTES:
                    # create() publishes by rename, but a foreign or partial
                    # file retries until the deadline
                    raise ValueError(f"{path}: ring file too small")
                mm = mmap.mmap(fd, size)
            except ValueError:
                os.close(fd)
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.01)
                continue
            os.close(fd)
            break
        if mm[0:8] != _MAGIC:
            mm.close()
            raise ValueError(f"{path}: not an infw ingest ring")
        hdr = np.frombuffer(mm, np.uint64, 6, 0)
        version = int(hdr[1]) >> 32
        slots = int(hdr[1]) & 0xFFFFFFFF
        if version != _VERSION:
            raise ValueError(f"{path}: ring version {version} != {_VERSION}")
        return cls(path, mm, False, slots, int(hdr[2]))

    def stage_pinned(self, alloc=None) -> None:
        """Make ``pop`` copy each record once into a host buffer of its slot
        and return views over that buffer: by default page-locked memory
        (a pinned torch tensor's), grown to the largest record the slot has
        held and kept for the ring's life.  ``alloc(nbytes)`` -> a uint8
        numpy array replaces the allocator."""
        if alloc is None:
            import torch

            def alloc(nbytes: int) -> np.ndarray:
                return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True).numpy()

        self._stage_alloc = alloc
        self._stage = [None] * self.slots

    @property
    def pinned(self) -> bool:
        return self._stage is not None

    def close(self) -> None:
        self._stage = None
        try:
            self._mm.close()
        except (BufferError, ValueError):
            pass  # live numpy views hold the mapping; the OS reclaims it

    # -- cursors -------------------------------------------------------------

    @property
    def head(self) -> int:
        return int(self._u64[3])

    @property
    def tail(self) -> int:
        return int(self._u64[4])

    def __len__(self) -> int:
        """Committed records not yet released."""
        return max(0, self.head - self.tail)

    def _slot_off(self, seq: int) -> int:
        return _HEADER_BYTES + (seq % self.slots) * self.slot_bytes

    def _advance_tail(self, seq: int) -> None:
        if int(self._u64[4]) != seq:
            raise RuntimeError(
                f"out-of-order ring release: tail={int(self._u64[4])}, released seq={seq}")
        self._u64[4] = seq + 1
        self._drain_skipped()

    def _drain_skipped(self) -> None:
        """Free skipped (corrupt) slots once the release order reaches them,
        never before, so the producer cannot overwrite earlier popped
        records that are still unreleased."""
        while int(self._u64[4]) in self._skipped:
            t = int(self._u64[4])
            self._skipped.discard(t)
            self._u64[4] = t + 1

    # -- producer ------------------------------------------------------------

    def max_packets(self, width: int = 7, with_flags: bool = True,
                    payload_width: int = 0) -> int:
        avail = self.slot_bytes - _SLOT_HEADER_BYTES
        per = width * 4 + (4 if with_flags else 0)
        if payload_width:
            per += int(payload_width) + 4
        return avail // per

    def reserve(self, n: int, width: int, with_flags: bool = False, payload_width: int = 0,
                timeout: Optional[float] = None):
        """The producer's first half: claim the next slot and return views
        to write in place -> (wire (n, width) uint32, flags (n,) int32 or
        None, token), or with ``payload_width`` L > 0 (wire, flags, payload
        (n, L) uint8, payload_len (n,) int32, token); ``commit(token)``
        publishes.  Blocks while the ring is full; raises TimeoutError past
        ``timeout`` seconds."""
        if n < 1 or width not in (4, 7):
            raise ValueError(f"bad record shape n={n} width={width}")
        if payload_width and payload_width not in PAYLOAD_PREFIX_WIDTHS:
            raise ValueError(
                f"payload prefix width {payload_width} not in {PAYLOAD_PREFIX_WIDTHS}")
        cap = self.max_packets(width, with_flags, payload_width)
        if n > cap:
            raise ValueError(f"record of {n} packets exceeds the slot capacity {cap}")
        deadline = None if timeout is None else time.monotonic() + timeout
        seq = self.head
        t_block = None
        while seq - self.tail >= self.slots:
            if t_block is None:
                t_block = time.monotonic()
            self._stats["blocked_waits"] += 1
            if deadline is not None and time.monotonic() > deadline:
                self._stats["blocked_us"] += int((time.monotonic() - t_block) * 1e6)
                raise TimeoutError("ingest ring full (consumer stalled)")
            time.sleep(0.0005)
        if t_block is not None:
            self._stats["blocked_us"] += int((time.monotonic() - t_block) * 1e6)
        off = self._slot_off(seq)
        hdr32 = np.frombuffer(self._mm, np.uint32, 4, off + 8)
        flags = FLAG_TCP_FLAGS if with_flags else 0
        if payload_width:
            flags |= FLAG_PAYLOAD
        hdr32[0] = n
        hdr32[1] = width
        hdr32[2] = flags
        hdr32[3] = int(payload_width)
        wire = np.frombuffer(self._mm, np.uint32, n * width,
                             off + _SLOT_HEADER_BYTES).reshape(n, width)
        cursor = off + _SLOT_HEADER_BYTES + n * width * 4
        fl = None
        if with_flags:
            fl = np.frombuffer(self._mm, np.int32, n, cursor)
            cursor += n * 4
        if not payload_width:
            return wire, fl, (seq, off)
        pay = np.frombuffer(self._mm, np.uint8, n * payload_width,
                            cursor).reshape(n, payload_width)
        plen = np.frombuffer(self._mm, np.int32, n, cursor + n * payload_width)
        return wire, fl, pay, plen, (seq, off)

    def commit(self, token, v4_only: bool = False) -> int:
        """The producer's second half: publish the reserved record (the
        commit word, then the head)."""
        seq, off = token
        hdr32 = np.frombuffer(self._mm, np.uint32, 4, off + 8)
        if v4_only:
            hdr32[2] |= FLAG_V4_ONLY
        np.frombuffer(self._mm, np.uint64, 1, off)[0] = seq + 1
        self._u64[3] = seq + 1
        self._stats["pushed"] += 1
        depth = len(self)
        if depth > self._stats["depth_hwm_prod"]:
            self._stats["depth_hwm_prod"] = depth
        return seq

    def push(self, wire: np.ndarray, v4_only: bool = False,
             tcp_flags: Optional[np.ndarray] = None, payload: Optional[np.ndarray] = None,
             payload_len: Optional[np.ndarray] = None, timeout: Optional[float] = None) -> int:
        """reserve, copy in place and commit in one call.  ``payload`` must
        already be (n, L) with L in PAYLOAD_PREFIX_WIDTHS
        (kernels.wire_decode.pad_payload_prefix)."""
        n, width = wire.shape
        if payload is None:
            wv, fv, token = self.reserve(n, width, with_flags=tcp_flags is not None,
                                         timeout=timeout)
        else:
            wv, fv, pv, lv, token = self.reserve(n, width, with_flags=tcp_flags is not None,
                                                 payload_width=payload.shape[1],
                                                 timeout=timeout)
            np.copyto(pv, np.asarray(payload, np.uint8))
            np.copyto(lv, np.asarray(payload_len, np.int32) if payload_len is not None
                      else np.full(n, payload.shape[1], np.int32))
        np.copyto(wv, wire)
        if tcp_flags is not None:
            np.copyto(fv, np.asarray(tcp_flags, np.int32))
        return self.commit(token, v4_only=v4_only)

    # -- consumer ------------------------------------------------------------

    def pop(self, timeout: float = 0.0) -> Optional[RingChunk]:
        """The next committed record as views over its slot, or None when
        none is committed within ``timeout``.  The slot is not reclaimed
        until the chunk's ``release()``.  A corrupt record raises
        ValueError and is skipped."""
        deadline = time.monotonic() + timeout
        seq = self._read_seq
        while True:
            if self.head > seq:
                off = self._slot_off(seq)
                if int(np.frombuffer(self._mm, np.uint64, 1, off)[0]) == seq + 1:
                    break
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.0005)
        hdr32 = np.frombuffer(self._mm, np.uint32, 4, off + 8)
        n, width, flags = int(hdr32[0]), int(hdr32[1]), int(hdr32[2])
        pw = int(hdr32[3]) if flags & FLAG_PAYLOAD else 0
        # the bound uses the record's own layout: a record without flags
        # holds more packets than a flagged one of the same slot size
        cap = self.max_packets(width, bool(flags & FLAG_TCP_FLAGS), pw)
        bad_pw = bool(flags & FLAG_PAYLOAD) and pw not in PAYLOAD_PREFIX_WIDTHS
        if width not in (4, 7) or n < 1 or bad_pw or n > cap:
            # fail closed on a torn or corrupt record: only the read cursor
            # skips it; its slot frees when the release order reaches it
            self._read_seq = seq + 1
            self._skipped.add(seq)
            self._drain_skipped()
            raise ValueError(
                f"corrupt ring record at seq {seq}: n={n} width={width} payload_width={pw}")
        nbytes = n * (width * 4 + (4 if flags & FLAG_TCP_FLAGS else 0) + (pw + 4 if pw else 0))
        src, base = self._mm, off + _SLOT_HEADER_BYTES
        if self._stage is not None:
            # the one host copy of the record, into its slot's buffer
            i = seq % self.slots
            buf = self._stage[i]
            if buf is None or buf.nbytes < nbytes:
                buf = self._stage[i] = self._stage_alloc(nbytes)
            buf[:nbytes] = np.frombuffer(self._mm, np.uint8, nbytes, base)
            src, base = buf, 0
        wire = np.frombuffer(src, np.uint32, n * width, base).reshape(n, width)
        cursor = base + n * width * 4
        fl = None
        if flags & FLAG_TCP_FLAGS:
            fl = np.frombuffer(src, np.int32, n, cursor)
            cursor += n * 4
        pay = plen = None
        if pw:
            pay = np.frombuffer(src, np.uint8, n * pw, cursor).reshape(n, pw)
            plen = np.frombuffer(src, np.int32, n, cursor + n * pw)
        self._stats["popped"] += 1
        depth = self.head - seq
        if depth > self._stats["depth_hwm_cons"]:
            self._stats["depth_hwm_cons"] = depth
        self._read_seq = seq + 1
        return RingChunk(self, seq, wire, fl, bool(flags & FLAG_V4_ONLY), payload=pay,
                         payload_len=plen)

    # -- observability -------------------------------------------------------

    def counter_values(self) -> dict:
        """ring_* gauges for /metrics."""
        return {
            "ring_pushed_total": self._stats["pushed"],
            "ring_popped_total": self._stats["popped"],
            "ring_blocked_waits_total": self._stats["blocked_waits"],
            "ring_blocked_us_total": self._stats["blocked_us"],
            "ring_depth": len(self),
            "ring_depth_hwm": max(self._stats["depth_hwm_prod"], self._stats["depth_hwm_cons"]),
            "ring_slots": self.slots,
        }


def ring_path(state_dir: str) -> str:
    """The daemon's default ring location under its state dir."""
    return os.path.join(state_dir, "ingest.ring")
