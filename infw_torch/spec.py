"""Declarative firewall spec types (the IngressNodeFirewall CR).

Python equivalents of the reference's IngressNodeFirewall CRD
(api/v1alpha1/ingressnodefirewall_types.go), including the discriminated
protocol-config union.  Plain dataclasses built from dicts shaped exactly
like the reference CRs (``from_dict``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

PROTOCOL_TYPE_ICMP = "ICMP"
PROTOCOL_TYPE_ICMP6 = "ICMPv6"
PROTOCOL_TYPE_TCP = "TCP"
PROTOCOL_TYPE_UDP = "UDP"
PROTOCOL_TYPE_SCTP = "SCTP"
# "" is a legal discriminator value (ingressnodefirewall_types.go:61) and
# compiles to the protocol==0 catch-all rule.
PROTOCOL_TYPE_UNSET = ""

ACTION_ALLOW = "Allow"
ACTION_DENY = "Deny"


@dataclass
class ObjectMeta:
    name: str = ""
    labels: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "ObjectMeta":
        return cls(name=d.get("name", ""), labels=dict(d.get("labels", {}) or {}))


@dataclass
class IngressNodeFirewallICMPRule:
    """ICMP/ICMPv6 matcher (ingressnodefirewall_types.go:25-39)."""

    icmp_type: int = 0
    icmp_code: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "IngressNodeFirewallICMPRule":
        return cls(icmp_type=int(d.get("icmpType", 0)), icmp_code=int(d.get("icmpCode", 0)))


@dataclass
class IngressNodeFirewallProtoRule:
    """Transport-port matcher (ingressnodefirewall_types.go:42-48): an
    integer selects a single port, a "start-end" string a range."""

    ports: Union[int, str] = 0

    @classmethod
    def from_dict(cls, d: dict) -> "IngressNodeFirewallProtoRule":
        return cls(ports=d.get("ports", 0))


@dataclass
class IngressNodeProtocolConfig:
    """Discriminated union of per-protocol config
    (ingressnodefirewall_types.go:50-88); the CEL cross-field rules are
    enforced by infw_torch.schema."""

    protocol: str = PROTOCOL_TYPE_UNSET
    tcp: Optional[IngressNodeFirewallProtoRule] = None
    udp: Optional[IngressNodeFirewallProtoRule] = None
    sctp: Optional[IngressNodeFirewallProtoRule] = None
    icmp: Optional[IngressNodeFirewallICMPRule] = None
    icmpv6: Optional[IngressNodeFirewallICMPRule] = None

    @classmethod
    def from_dict(cls, d: dict) -> "IngressNodeProtocolConfig":
        def opt(key, typ):
            return typ.from_dict(d[key]) if key in d and d[key] is not None else None

        return cls(
            protocol=d.get("protocol", PROTOCOL_TYPE_UNSET),
            tcp=opt("tcp", IngressNodeFirewallProtoRule),
            udp=opt("udp", IngressNodeFirewallProtoRule),
            sctp=opt("sctp", IngressNodeFirewallProtoRule),
            icmp=opt("icmp", IngressNodeFirewallICMPRule),
            icmpv6=opt("icmpv6", IngressNodeFirewallICMPRule),
        )


@dataclass
class IngressNodeFirewallProtocolRule:
    """One ordered rule (ingressnodefirewall_types.go:90-107).  ``order`` must
    be >=1 and unique; index 0 of the compiled table is the reserved slot."""

    order: int = 0
    protocol_config: IngressNodeProtocolConfig = field(
        default_factory=IngressNodeProtocolConfig
    )
    action: str = ACTION_ALLOW

    @classmethod
    def from_dict(cls, d: dict) -> "IngressNodeFirewallProtocolRule":
        return cls(
            order=int(d.get("order", 0)),
            protocol_config=IngressNodeProtocolConfig.from_dict(
                d.get("protocolConfig", {}) or {}
            ),
            action=d.get("action", ACTION_ALLOW),
        )


@dataclass
class IngressNodeFirewallRules:
    """sourceCIDRs + ordered rules (ingressnodefirewall_types.go:138-147)."""

    source_cidrs: List[str] = field(default_factory=list)
    rules: List[IngressNodeFirewallProtocolRule] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "IngressNodeFirewallRules":
        return cls(
            source_cidrs=list(d.get("sourceCIDRs", []) or []),
            rules=[
                IngressNodeFirewallProtocolRule.from_dict(r)
                for r in d.get("rules", []) or []
            ],
        )


@dataclass
class IngressNodeFirewallSpec:
    """ingressnodefirewall_types.go:149-164.  ``node_selector`` carries the
    matchLabels map of the reference's metav1.LabelSelector."""

    node_selector: Dict[str, str] = field(default_factory=dict)
    ingress: List[IngressNodeFirewallRules] = field(default_factory=list)
    interfaces: List[str] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "IngressNodeFirewallSpec":
        sel = d.get("nodeSelector", {}) or {}
        match_labels = sel.get("matchLabels", sel) or {}
        return cls(
            node_selector=dict(match_labels),
            ingress=[
                IngressNodeFirewallRules.from_dict(i) for i in d.get("ingress", []) or []
            ],
            interfaces=list(d.get("interfaces", []) or []),
        )


@dataclass
class IngressNodeFirewall:
    """Cluster-scoped firewall policy (ingressnodefirewall_types.go:185-191)."""

    KIND = "IngressNodeFirewall"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: IngressNodeFirewallSpec = field(default_factory=IngressNodeFirewallSpec)

    @classmethod
    def from_dict(cls, d: dict) -> "IngressNodeFirewall":
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata", {}) or {}),
            spec=IngressNodeFirewallSpec.from_dict(d.get("spec", {}) or {}),
        )
