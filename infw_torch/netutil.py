"""CIDR / address parsing helpers.

Reproduces the semantics of Go's net.ParseCIDR as used by the reference's
LPM key construction (pkg/ebpf/ingress_node_firewall_loader.go:530-547) and webhook
(pkg/webhook/webhook.go:253-258):

- the "/len" part is mandatory;
- the *unmasked* address bytes go into the key data;
- IPv4 and IPv4-mapped-IPv6 addresses store the 4-byte form at the front of
  the 16-byte key, everything else stores the 16-byte form;
- prefix_len is the CIDR mask length plus the 32 ifindex key bits.
"""
from __future__ import annotations

import ipaddress
from dataclasses import dataclass
from typing import Optional

from .constants import IFINDEX_KEY_LENGTH


class CIDRParseError(ValueError):
    pass


@dataclass(frozen=True)
class ParsedCIDR:
    ip_data: bytes      # 16 bytes; v4 addresses occupy the first 4, rest zero
    mask_len: int       # CIDR prefix length as written
    is_v4_data: bool    # True if ip_data holds the 4-byte form


def parse_cidr(cidr: str) -> ParsedCIDR:
    if not isinstance(cidr, str) or "/" not in cidr:
        raise CIDRParseError(f"invalid CIDR address: {cidr!r}")
    try:
        iface = ipaddress.ip_interface(cidr)
    except ValueError as e:
        raise CIDRParseError(f"invalid CIDR address: {cidr!r}: {e}")

    ip = iface.ip
    mask_len = iface.network.prefixlen
    data = bytearray(16)
    if isinstance(ip, ipaddress.IPv4Address):
        data[0:4] = ip.packed
        is_v4 = True
    else:
        v4 = ip.ipv4_mapped
        if v4 is not None:
            # Go's ip.To4() returns the 4-byte form for v4-mapped addresses
            # (loader.go:537-538); the prefix length stays as written.
            data[0:4] = v4.packed
            is_v4 = True
        else:
            data[0:16] = ip.packed
            is_v4 = False
    return ParsedCIDR(ip_data=bytes(data), mask_len=mask_len, is_v4_data=is_v4)


def validate_source_cidr(cidr: str) -> Optional[str]:
    """webhook.go:253-258 — returns a reason string or None if valid."""
    try:
        parse_cidr(cidr)
    except CIDRParseError as e:
        return f"must define valid IPV4 or IPV6 CIDR: {e}"
    return None


def key_prefix_len(mask_len: int) -> int:
    """loader.go:543 — LPM prefixLen counts the 32 ifindex bits too."""
    return mask_len + IFINDEX_KEY_LENGTH


def ip_str_to_words(addr: str) -> tuple:
    """Parse a bare IP address into (word0..word3, is_v4) big-endian 32-bit
    words of the 16-byte key layout (v4 in the first word)."""
    ip = ipaddress.ip_address(addr)
    data = bytearray(16)
    if isinstance(ip, ipaddress.IPv4Address):
        data[0:4] = ip.packed
        is_v4 = True
    else:
        data[0:16] = ip.packed
        is_v4 = False
    words = tuple(int.from_bytes(data[i : i + 4], "big") for i in range(0, 16, 4))
    return words, is_v4
