"""Open-loop ring producer for a daemon started with ``--ring``: the port's
copy of ``tools/loadgen.py``'s ring mode.

Packets are scheduled by an arrival process (``testing.poisson_arrivals``
or ``burst_arrivals``) at a fixed offered load and grouped into records of
``--file-packets`` packets; each record is packed into the 4- or 7-word
wire and written IN PLACE into the next slot of the daemon's ingest ring
(``infw_torch.ring``) at its first packet's scheduled arrival time, with
its TCP flags under ``--attack`` and its payload prefix column under
``--payload``.  The schedule is fixed against one anchor up front, so a
slow consumer makes the producer fall visibly behind (reported at the
end) instead of stretching the offered load; a full ring blocks the
producer, and that wait is reported apart from its own lag.

The traffic is synthetic (uniform random IPv4 and IPv6 addresses and
protocols: the deny rate depends on the daemon's ruleset).  For the same
arguments and ``--seed`` it is byte for byte what ``tools/loadgen.py
--ring`` writes, so the two producers are interchangeable; the ring
file's layout is shared too.  The port's daemon reads frames files from
any producer, so this copy has no file-drop mode.

    python -m infw_torch.daemon --state-dir S --node-name n --ring S/ingest.ring \\
        [--flow-table 131072] [--payload default] [--resident --superbatch-k 4]
    python -m infw_torch.tools.loadgen --ring S/ingest.ring --rate 1000000 \\
        --n 1000000 [--file-packets 4096] [--seed 7] [--ifindex 2] \\
        [--established-fraction 0.9] [--attack synflood] \\
        [--payload attack-mix] [--dry-run]

Prints a JSON summary of the schedule first and, after the run, one of
what happened (durations, lags, the ring's counters).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np

from .. import testing
from ..constants import TCP_ACK, TCP_SYN
from ..kernels.wire_decode import PAYLOAD_PREFIX_WIDTHS
from ..packets import PacketBatch

PAYLOAD_SHAPES = ("none", "http", "attack-mix")
#: the second key of the payload column's child generator (b"payl")
PAYLOAD_RNG_KEY = 0x7061796C


def synth_columns(rng: np.random.Generator, n: int, v6_fraction: float,
                  established_fraction: float = 0.0, file_packets: int = 4096):
    """Uniform synthetic packet columns (no table bias), expanded from a
    flow pool: with ``established_fraction`` > 0 the lanes draw from
    ``testing.flow_locality_fids`` chunked at ``file_packets``, so one
    record is the flow cache's insert granularity.  -> (columns,
    n_flows)."""
    if established_fraction > 0.0:
        fid, _fresh, n_flows = testing.flow_locality_fids(
            rng, n, established_fraction, chunk_packets=file_packets)
    else:
        fid = np.arange(n)
        n_flows = n
    kind = np.where(rng.random(n_flows) < v6_fraction, 2, 1).astype(np.int32)
    ip = rng.integers(0, 256, (n_flows, 16), dtype=np.uint8)
    ip[kind == 1, 4:] = 0
    ip_words = np.ascontiguousarray(ip).view(">u4").astype(np.uint32).reshape(n_flows, 4)
    proto = np.asarray([6, 17, 132, 1, 58], np.int32)[rng.integers(0, 5, n_flows)]
    dst_port = rng.integers(0, 65536, n_flows).astype(np.int32)
    icmp_type = rng.integers(0, 256, n_flows).astype(np.int32)
    icmp_code = rng.integers(0, 3, n_flows).astype(np.int32)
    return {
        "kind": kind[fid], "ip_words": ip_words[fid], "proto": proto[fid],
        "dst_port": dst_port[fid], "icmp_type": icmp_type[fid], "icmp_code": icmp_code[fid],
    }, n_flows


def encode_attack_labels(mask: np.ndarray, file_packets: int) -> list:
    """The (n,) bool mask of attack lanes as one hex bitmap a record
    (little bit first), so a measuring consumer scores against exactly the
    lanes the generator wrote."""
    mask = np.asarray(mask, bool)
    fp = max(int(file_packets), 1)
    return [np.packbits(mask[lo: lo + fp], bitorder="little").tobytes().hex()
            for lo in range(0, len(mask), fp)]


def decode_attack_labels(hex_bitmaps: list, n: int, file_packets: int) -> np.ndarray:
    """encode_attack_labels' inverse -> the (n,) bool mask."""
    fp = max(int(file_packets), 1)
    mask = np.zeros(n, bool)
    for i, h in enumerate(hex_bitmaps):
        lo = i * fp
        hi = min(lo + fp, n)
        bits = np.unpackbits(np.frombuffer(bytes.fromhex(h), np.uint8), bitorder="little")
        mask[lo:hi] = bits[: hi - lo].astype(bool)
    return mask


def attack_lane_src_ids(mask: np.ndarray, n_src: int) -> np.ndarray:
    """(n,) int32 attacker index of each lane, -1 for background: an attack
    lane takes its position in the attack sequence modulo ``n_src``, the
    assignment inject_attack makes."""
    mask = np.asarray(mask, bool)
    ids = np.full(len(mask), -1, np.int32)
    idx = np.nonzero(mask)[0]
    ids[idx] = (np.arange(len(idx)) % max(int(n_src), 1)).astype(np.int32)
    return ids


def synth_payload(rng: np.random.Generator, n: int, shape: str, plen: int, pattern_seed: int,
                  n_patterns: int, attack_fraction: float, file_packets: int):
    """Payload prefix columns: ``http`` the benign request mix
    (payload.benign_payloads); ``attack-mix`` also overwrites a seeded
    ``attack_fraction`` of the lanes with signature-bearing prefixes
    (payload.attack_payloads) from the set a daemon loads with ``--payload
    <n_patterns>`` at ``pattern_seed``.  -> (pay (n, plen) uint8, lengths
    (n,) int32, meta with the per-record labels).  About 15% of the
    planted lanes straddle the prefix's end and must not match: a label
    marks a planted lane, the host oracle says what matches."""
    from ..payload import attack_payloads, benign_payloads, signature_patterns

    pay, plens = benign_payloads(rng, n, plen=plen)
    meta = {
        "payload_shape": shape,
        "payload_prefix_bytes": int(plen),
        "payload_bytes_per_packet": int(plen) + 4,  # the bytes and the length word
        "payload_pattern_seed": int(pattern_seed),
        "payload_patterns": int(n_patterns),
    }
    if shape == "attack-mix":
        pats = signature_patterns(np.random.default_rng(pattern_seed), n_patterns, plen=plen)
        mask = rng.random(n) < float(attack_fraction)
        k = int(mask.sum())
        if k:
            apay, alens = attack_payloads(rng, k, pats, plen=plen)
            pay[mask] = apay
            plens[mask] = alens
        meta["payload_signature_packets"] = k
        meta["payload_labels"] = {"record_bitmaps_hex": encode_attack_labels(mask, file_packets)}
    return pay, np.asarray(plens, np.int32), meta


def inject_attack(rng: np.random.Generator, c: dict, n: int, mode: str, attack_fraction: float,
                  attack_start: float, n_attackers: int, file_packets: int):
    """Overwrite a seeded share of the lanes with an attack (the modes of
    testing.attack_trace_batch, without tables): from ``attack_start`` of
    the stream, rounded down to a record boundary, ``attack_fraction`` of
    the lanes.  -> (tcp_flags (n,) int32, meta with the labels)."""
    cp = max(int(file_packets), 1)
    start = (int(n * float(attack_start)) // cp) * cp
    mask = (np.arange(n) >= start) & (rng.random(n) < float(attack_fraction))
    k = int(mask.sum())
    n_src = 1 if mode == "portscan" else max(1, int(n_attackers))
    srcs = np.zeros((n_src, 4), np.uint32)
    srcs[:, 0] = rng.integers(1, 1 << 32, n_src, dtype=np.uint64)
    lane_src = np.arange(k) % n_src
    c["kind"][mask] = 1
    c["ip_words"][mask] = srcs[lane_src]
    c["proto"][mask] = 6
    c["icmp_type"][mask] = 0
    c["icmp_code"][mask] = 0
    flags = np.where(c["proto"] == 6, TCP_ACK, 0).astype(np.int32)
    if mode == "synflood":
        c["dst_port"][mask] = 443
        flags[mask] = TCP_SYN
    elif mode == "portscan":
        c["dst_port"][mask] = np.arange(k) % 65536
    else:  # denystorm: one (source, port 80) pair an attacker
        c["dst_port"][mask] = 80
    meta = {
        "attack": mode, "attack_start_packet": int(start), "attack_packets": k,
        "attackers": [".".join(str(b) for b in int(s[0]).to_bytes(4, "big")) for s in srcs],
        "labels": {
            "onset_record": int(start) // cp,
            "attack_src_stride": int(n_src),
            "record_bitmaps_hex": encode_attack_labels(mask, cp),
        },
    }
    return flags, meta


def synth_wire_batch(rng: np.random.Generator, n: int, v6_fraction: float, ifindex: int,
                     established_fraction: float = 0.0, file_packets: int = 4096,
                     attack: Optional[dict] = None):
    """The synthetic columns as a PacketBatch (pkt_len drawn, every lane
    l4-parseable), with the attack's TCP flags column when ``attack`` is
    given.  -> (batch, n_flows, attack meta)."""
    c, n_flows = synth_columns(rng, n, v6_fraction, established_fraction, file_packets)
    meta = {}
    flags = None
    if attack is not None:
        flags, meta = inject_attack(rng, c, n, attack["mode"], attack["fraction"],
                                    attack["start"], attack["attackers"], file_packets)
    batch = PacketBatch(
        kind=c["kind"], l4_ok=np.ones(n, np.int32), ifindex=np.full(n, int(ifindex), np.int32),
        ip_words=np.ascontiguousarray(c["ip_words"], np.uint32), proto=c["proto"],
        dst_port=c["dst_port"], icmp_type=c["icmp_type"], icmp_code=c["icmp_code"],
        pkt_len=rng.integers(60, 1500, n).astype(np.int32),
    )
    if flags is not None:
        batch.tcp_flags = flags
    return batch, n_flows, meta


def push_records(ring, batch: PacketBatch, record_packets: int, pay: Optional[np.ndarray] = None,
                 plens: Optional[np.ndarray] = None, starts: Optional[np.ndarray] = None,
                 timeout: float = 30.0) -> dict:
    """Write ``batch`` into ``ring`` (an attached IngestRing) as records of
    ``record_packets`` lanes, each packed straight into its reserved slot
    with its TCP flags (``batch.tcp_flags``) and payload column, and
    committed at ``starts[i]`` seconds after the first (None: as fast as
    the ring takes them).  -> the run's durations, the worst schedule
    lag, the part of it not spent blocked on a full ring, and the time
    blocked."""
    n = len(batch)
    fp = int(record_packets)
    flags = getattr(batch, "tcp_flags", None)
    t0 = time.monotonic()
    worst_lag = worst_producer_lag = blocked_s = 0.0
    for i in range(-(-n // fp)):
        if starts is not None:
            lag = time.monotonic() - (t0 + float(starts[i]))
            if lag < 0:
                time.sleep(-lag)
            else:
                worst_lag = max(worst_lag, lag)
                worst_producer_lag = max(worst_producer_lag, lag - blocked_s)
        lo, hi = i * fp, min((i + 1) * fp, n)
        wire, v4_only = batch.pack_wire_subset(np.arange(lo, hi, dtype=np.int64))
        if pay is None:
            wv, fl, token = ring.reserve(wire.shape[0], wire.shape[1],
                                         with_flags=flags is not None, timeout=timeout)
        else:
            wv, fl, pv, lv, token = ring.reserve(wire.shape[0], wire.shape[1],
                                                 with_flags=flags is not None,
                                                 payload_width=pay.shape[1], timeout=timeout)
            np.copyto(pv, pay[lo:hi])
            np.copyto(lv, plens[lo:hi])
        np.copyto(wv, wire)
        if fl is not None:
            np.copyto(fl, flags[lo:hi])
        ring.commit(token, v4_only=v4_only)
        blocked_s = ring.counter_values()["ring_blocked_us_total"] / 1e6
    return {
        "actual_duration_s": time.monotonic() - t0,
        "worst_schedule_lag_s": worst_lag,
        "worst_producer_lag_s": worst_producer_lag,
        "ring_blocked_s": blocked_s,
        "ring_backpressured": blocked_s > 0.01,
        "fell_behind": worst_producer_lag > 0.01,
    }


def _attack_dict(args) -> Optional[dict]:
    if args.attack is None:
        return None
    return {"mode": args.attack, "fraction": args.attack_fraction, "start": args.attack_start,
            "attackers": args.attackers}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="infw_torch.tools.loadgen", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ring", required=True,
                   help="the daemon's ingest ring file (the daemon creates it with --ring)")
    p.add_argument("--rate", type=float, required=True, help="offered load, packets/second")
    p.add_argument("--n", type=int, required=True, help="total packets")
    p.add_argument("--burst", type=int, default=0,
                   help="> 0: back-to-back bursts of this many packets at the same mean rate "
                        "(testing.burst_arrivals) instead of Poisson arrivals")
    p.add_argument("--file-packets", type=int, default=4096, help="packets a record")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--ifindex", type=int, default=10)
    p.add_argument("--v6-fraction", type=float, default=0.3)
    p.add_argument("--established-fraction", type=float, default=0.0,
                   help="share of packets repeating a flow of an earlier record "
                        "(testing.flow_locality_fids): a --flow-table daemon's hit rate")
    p.add_argument("--attack", choices=testing.ATTACK_MODES, default=None,
                   help="a seeded attack over a share of the lanes after --attack-start, "
                        "with its TCP flags in the records: synflood (pure SYN from "
                        "--attackers sources), portscan (one source over the ports) or "
                        "denystorm (one (source, port 80) pair an attacker)")
    p.add_argument("--attack-fraction", type=float, default=0.4)
    p.add_argument("--attack-start", type=float, default=0.25)
    p.add_argument("--attackers", type=int, default=2)
    p.add_argument("--payload", choices=PAYLOAD_SHAPES, default="none",
                   help="the payload prefix column: http (benign request prefixes) or "
                        "attack-mix (the same with --payload-attack-fraction of the lanes "
                        "carrying signatures of the set a daemon loads with --payload "
                        "--payload-patterns at --payload-seed).  The daemon must run "
                        "--payload so its slots hold the column")
    p.add_argument("--payload-plen", type=int, default=64,
                   help=f"prefix bytes a packet, one of {PAYLOAD_PREFIX_WIDTHS}")
    p.add_argument("--payload-patterns", type=int, default=32)
    p.add_argument("--payload-seed", type=int, default=0,
                   help="the pattern set's seed (0: the daemon's --payload default set)")
    p.add_argument("--payload-attack-fraction", type=float, default=0.1)
    p.add_argument("--dry-run", action="store_true",
                   help="print the schedule's summary without writing or sleeping")
    args = p.parse_args(argv)
    if not 0.0 <= args.attack_fraction <= 1.0:
        p.error("--attack-fraction must be in [0, 1]")
    if not 0.0 <= args.attack_start < 1.0:
        p.error("--attack-start must be in [0, 1)")
    if args.attackers < 1:
        p.error("--attackers must be >= 1")
    if args.rate <= 0 or args.n <= 0 or args.file_packets <= 0:
        p.error("--rate, --n and --file-packets must be positive")
    if not 0.0 <= args.established_fraction < 1.0:
        p.error("--established-fraction must be in [0, 1)")
    if args.payload != "none":
        if args.payload_plen not in PAYLOAD_PREFIX_WIDTHS:
            p.error(f"--payload-plen must be one of {PAYLOAD_PREFIX_WIDTHS}")
        if args.payload_patterns < 1:
            p.error("--payload-patterns must be >= 1")
        if not 0.0 <= args.payload_attack_fraction <= 1.0:
            p.error("--payload-attack-fraction must be in [0, 1]")

    rng = np.random.default_rng(args.seed)
    if args.burst > 0:
        offs = testing.burst_arrivals(rng, args.rate, args.n, burst=args.burst)
    else:
        offs = testing.poisson_arrivals(rng, args.rate, args.n)
    batch, n_flows, attack_meta = synth_wire_batch(
        rng, args.n, args.v6_fraction, args.ifindex,
        established_fraction=args.established_fraction, file_packets=args.file_packets,
        attack=_attack_dict(args))
    pay = plens = None
    payload_meta = {}
    if args.payload != "none":
        # a child generator of --seed: the header stream is the same as with
        # --payload none
        pay, plens, payload_meta = synth_payload(
            np.random.default_rng([args.seed, PAYLOAD_RNG_KEY]), args.n, args.payload,
            args.payload_plen, args.payload_seed, args.payload_patterns,
            args.payload_attack_fraction, args.file_packets)
    fp = int(args.file_packets)
    n_rec = -(-args.n // fp)
    starts = offs[::fp][:n_rec]
    print(json.dumps({
        "n": int(args.n), "rate_pps": float(args.rate),
        "process": f"burst:{args.burst}" if args.burst > 0 else "poisson",
        "mode": "ring", "records": int(n_rec), "file_packets": fp,
        "duration_s": float(offs[-1]), "seed": int(args.seed),
        "established_fraction": float(args.established_fraction),
        "n_flows": int(n_flows), **attack_meta, **payload_meta,
    }), flush=True)
    if args.dry_run:
        return 0
    from ..ring import IngestRing

    ring = IngestRing.attach(args.ring)
    try:
        done = push_records(ring, batch, fp, pay, plens, starts)
        print(json.dumps({"offered_duration_s": float(offs[-1]), **done,
                          **{k: int(v) for k, v in ring.counter_values().items()}}), flush=True)
    finally:
        ring.close()
    if done["ring_backpressured"]:
        print(f"loadgen: WARNING the full ring blocked the producer for "
              f"{done['ring_blocked_s'] * 1e3:.1f} ms in all (the consumer fell behind): the "
              f"offered load was lower than asked", file=sys.stderr)
    if done["fell_behind"]:
        print(f"loadgen: WARNING fell behind its schedule by "
              f"{done['worst_producer_lag_s'] * 1e3:.1f} ms beyond the ring's blocking (a slow "
              f"producer): the offered load was lower than asked", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
