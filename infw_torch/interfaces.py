"""Virtual network-interface registry.

The reference resolves interface names via netlink
(pkg/interfaces/interfaces.go): validity = up and not loopback (:24-35),
name -> index (:53-60), and bond interfaces expand to their member indices
(:85-116).  The dataplane is fed packet batches rather than NIC queues, so
interfaces are a declarative registry the caller fills; the resolution
semantics (bond expansion, invalid interfaces skipped rather than errors)
are the reference's.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional


class InterfaceError(RuntimeError):
    pass


@dataclass
class Interface:
    name: str
    index: int
    up: bool = True
    loopback: bool = False
    type: str = "device"          # "device" | "bond"
    master: Optional[str] = None  # bond master name for member links
    xdp_attached: bool = False    # mirrors netlink's Xdp.Attached flag


class InterfaceRegistry:
    """In-memory mirror of the host link table."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ifaces: Dict[str, Interface] = {}

    def add(self, iface: Interface) -> None:
        with self._lock:
            self._ifaces[iface.name] = iface

    def get(self, name: str) -> Optional[Interface]:
        with self._lock:
            return self._ifaces.get(name)

    def list(self) -> List[Interface]:
        with self._lock:
            return list(self._ifaces.values())

    def is_valid_interface_name_and_state(self, name: str) -> bool:
        """IsValidInterfaceNameAndState (interfaces.go:24-35)."""
        iface = self.get(name)
        return iface is not None and iface.up and not iface.loopback

    def get_interface_index(self, name: str) -> int:
        """GetInterfaceIndex (interfaces.go:53-60)."""
        iface = self.get(name)
        if iface is None:
            raise InterfaceError(f"looking up network interface name {name!r}: not found")
        return iface.index

    def get_interface_indices(self, name: str) -> List[int]:
        """GetInterfaceIndices (interfaces.go:85-116): non-bond interfaces
        resolve to their own index; bonds resolve to all member indices."""
        iface = self.get(name)
        if iface is None:
            raise InterfaceError(f"link {name!r} not found")
        if iface.type != "bond":
            return [iface.index]
        return [l.index for l in self.list() if l.master == name]

    def get_interfaces_with_xdp_attached(self) -> List[str]:
        """GetInterfacesWithXDPAttached (interfaces.go:38-50)."""
        return [l.name for l in self.list() if l.xdp_attached]

    def set_xdp(self, name: str, attached: bool) -> None:
        """The daemon's attach/detach seam (the XDP link up/down)."""
        iface = self.get(name)
        if iface is None:
            raise InterfaceError(f"link {name!r} not found")
        iface.xdp_attached = attached


# The process-wide registry the daemon uses unless given one: a single-NIC
# node (eth0, index 2).
default_registry = InterfaceRegistry()
default_registry.add(Interface(name="eth0", index=2))
