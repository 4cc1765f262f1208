"""Dataplane ABI constants.

These mirror the reference dataplane contract in
bpf/ingress_node_firewall.h:4-23 (constants, action values and the
action/ruleId bit-packing macros).  They are the conformance contract that
every classifier path (the CUDA kernel, its plain PyTorch version, the NumPy
oracle) must implement bit-exactly.
"""

# Capacity constants (ingress_node_firewall.h:13-16).
MAX_TARGETS = 1024
MAX_RULES_PER_TARGET = 100
MAX_EVENT_DATA = 256
INVALID_RULE_ID = 0

# XDP verdicts.  The reference aliases firewall actions onto XDP actions
# (ingress_node_firewall.h:10-12): UNDEF=XDP_ABORTED, DENY=XDP_DROP,
# ALLOW=XDP_PASS.
XDP_ABORTED = 0
XDP_DROP = 1
XDP_PASS = 2

UNDEF = XDP_ABORTED
DENY = XDP_DROP
ALLOW = XDP_PASS

# Ethertypes (ingress_node_firewall.h:5-7).
ETH_P_IP = 0x0800
ETH_P_IPV6 = 0x86DD
ETH_P_ARP = 0x0806

# L4 protocol numbers used by the rule scan
# (bpf/ingress_node_firewall_kernel.c:231-233,247,329).
IPPROTO_ICMP = 1
IPPROTO_TCP = 6
IPPROTO_UDP = 17
IPPROTO_ICMPV6 = 58
IPPROTO_SCTP = 132

# LPM key geometry: the match data is (ingress_ifindex:32bits || ip_data:128bits)
# and entry prefixLen counts the ifindex bits too
# (pkg/ebpf/ingress_node_firewall_loader.go:35,543).
IFINDEX_KEY_LENGTH = 32
# Packet-side key prefix lengths (kernel.c:207,293): entries with a longer
# prefixLen than the packet key cannot match.
V4_KEY_PREFIX_LEN = 64   # 32 ifindex bits + 32 IPv4 bits
V6_KEY_PREFIX_LEN = 160  # 32 ifindex bits + 128 IPv6 bits

# Packet "kind" codes used by the batched representation of the ethertype
# switch in ingress_node_firewall_main (kernel.c:423-439).
KIND_MALFORMED = 0  # short/invalid ethernet header   -> XDP_DROP
KIND_IPV4 = 1       # ETH_P_IP                        -> ipv4_firewall_lookup
KIND_IPV6 = 2       # ETH_P_IPV6                      -> ipv6_firewall_lookup
KIND_OTHER = 3      # any other ethertype             -> XDP_PASS


def get_action(result: int) -> int:
    """GET_ACTION macro (ingress_node_firewall.h:18)."""
    return result & 0xFF


def set_action(action: int) -> int:
    """SET_ACTION macro (ingress_node_firewall.h:19)."""
    return action & 0xFF


def get_rule_id(result: int) -> int:
    """GET_RULE_ID macro (ingress_node_firewall.h:20)."""
    return (result >> 8) & 0xFFFFFF


def set_actionrule_response(action: int, rule_id: int) -> int:
    """SET_ACTIONRULE_RESPONSE macro (ingress_node_firewall.h:22-23)."""
    return ((rule_id & 0xFFFFFF) << 8) | (action & 0xFF)


# TCP flag bits of the optional per-packet flags column (PacketBatch
# .tcp_flags); 0, the value when the source carries no flags, makes the
# flow tier's TCP model established-on-first-packet.
TCP_FIN = 0x01
TCP_SYN = 0x02
TCP_RST = 0x04
TCP_ACK = 0x10

# Flow entry states: EMPTY slots are free; NEW is a TCP flow that has only
# shown a pure SYN (tracked, never served); EST and FIN serve their cached
# verdict.
FLOW_EMPTY = 0
FLOW_NEW = 1
FLOW_EST = 2
FLOW_FIN = 3

# Words of the flow key: tenant, ifindex, the 4 source-IP words, then
# proto | dst_port << 8 | kind << 24 | l4_ok << 26 and icmp_type |
# icmp_code << 8.
FLOW_KEY_WORDS = 8
