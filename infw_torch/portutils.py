"""Port / port-range parsing.

Mirrors the reference's pkg/utils/utils.go: a string with a hyphen is a
range, get_port rejects ranges and port 0, get_range rejects start>end,
start==end and start==0.
"""
from __future__ import annotations

from typing import Tuple

from .spec import IngressNodeFirewallProtoRule


class PortParseError(ValueError):
    pass


def is_range(p: IngressNodeFirewallProtoRule) -> bool:
    """utils.go:13-18 — only string-typed ports containing '-' are ranges."""
    return isinstance(p.ports, str) and "-" in p.ports


def _parse_uint16(s: str, what: str) -> int:
    try:
        v = int(s, 10)
    except (ValueError, TypeError):
        raise PortParseError(f"invalid {what} number: {s!r}")
    if not (0 <= v <= 0xFFFF) or (isinstance(s, str) and s.strip() != s):
        raise PortParseError(f"invalid {what} number: {s!r}")
    return v


def get_port(p: IngressNodeFirewallProtoRule) -> int:
    """utils.go:20-32."""
    if is_range(p):
        raise PortParseError("port is a range and not an individual port")
    port = _parse_uint16(str(p.ports), "Port")
    if port == 0:
        raise PortParseError("invalid port number 0")
    return port


def get_range(p: IngressNodeFirewallProtoRule) -> Tuple[int, int]:
    """utils.go:34-61."""
    if not is_range(p):
        raise PortParseError("port is not a range")
    parts = str(p.ports).split("-", 1)
    if len(parts) != 2:
        raise PortParseError(
            f"invalid ports range. Expected two integers separated by hyphen but found {p.ports!r}"
        )
    start = _parse_uint16(parts[0], "start port")
    end = _parse_uint16(parts[1], "end port")
    if start > end:
        raise PortParseError("invalid port range. Start port is greater than end port")
    if start == end:
        raise PortParseError(
            "invalid port range. Start and end port are equal. "
            "Remove the hyphen and enter a single port"
        )
    if start == 0:
        raise PortParseError("invalid start port 0")
    return start, end
