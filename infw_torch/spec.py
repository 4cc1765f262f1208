"""Declarative firewall spec types (the IngressNodeFirewall and
IngressNodeFirewallNodeState CRs).

Python equivalents of the reference's IngressNodeFirewall CRD
(api/v1alpha1/ingressnodefirewall_types.go), including the discriminated
protocol-config union, and of the per-node NodeState CRD the daemon serves
(ingressnodefirewallnodestate_types.go).  Plain dataclasses built from and
written to dicts shaped exactly like the reference CRs (``from_dict`` /
``to_dict``).
"""
from __future__ import annotations

import dataclasses
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

# NodeState .status.syncStatus (ingressnodefirewallnodestate_types.go:44-52)
NODE_STATE_SYNC_ERROR = "Error"
NODE_STATE_SYNC_OK = "Synchronized"


@dataclass
class OwnerReference:
    api_version: str = ""
    kind: str = ""
    name: str = ""
    uid: str = ""

    def to_dict(self) -> dict:
        return {"apiVersion": self.api_version, "kind": self.kind, "name": self.name,
                "uid": self.uid}

    @classmethod
    def from_dict(cls, d: dict) -> "OwnerReference":
        return cls(api_version=d.get("apiVersion", ""), kind=d.get("kind", ""),
                   name=d.get("name", ""), uid=d.get("uid", ""))


@dataclass
class ObjectMeta:
    """The metadata fields the controllers read: identity, labels, owners,
    and the finalizer / deletion-timestamp pair of a finalized delete."""

    name: str = ""
    namespace: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    owner_references: List[OwnerReference] = field(default_factory=list)
    finalizers: List[str] = field(default_factory=list)
    deletion_timestamp: Optional[float] = None
    uid: str = ""
    resource_version: int = 0

    def to_dict(self) -> dict:
        d: dict = {"name": self.name}
        if self.namespace:
            d["namespace"] = self.namespace
        if self.labels:
            d["labels"] = dict(self.labels)
        if self.owner_references:
            d["ownerReferences"] = [o.to_dict() for o in self.owner_references]
        if self.finalizers:
            d["finalizers"] = list(self.finalizers)
        if self.deletion_timestamp is not None:
            d["deletionTimestamp"] = self.deletion_timestamp
        if self.uid:
            d["uid"] = self.uid
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ObjectMeta":
        return cls(
            name=d.get("name", ""),
            namespace=d.get("namespace", ""),
            labels=dict(d.get("labels", {}) or {}),
            owner_references=[
                OwnerReference.from_dict(o) for o in d.get("ownerReferences", []) or []
            ],
            finalizers=list(d.get("finalizers", []) or []),
            deletion_timestamp=d.get("deletionTimestamp"),
            uid=d.get("uid", ""),
        )


@dataclass
class IngressNodeFirewallICMPRule:
    """ICMP/ICMPv6 matcher (ingressnodefirewall_types.go:25-39)."""

    icmp_type: int = 0
    icmp_code: int = 0

    def to_dict(self) -> dict:
        return {"icmpType": self.icmp_type, "icmpCode": self.icmp_code}

    @classmethod
    def from_dict(cls, d: dict) -> "IngressNodeFirewallICMPRule":
        return cls(icmp_type=int(d.get("icmpType", 0)), icmp_code=int(d.get("icmpCode", 0)))


@dataclass
class IngressNodeFirewallProtoRule:
    """Transport-port matcher (ingressnodefirewall_types.go:42-48): an
    integer selects a single port, a "start-end" string a range."""

    ports: Union[int, str] = 0

    def to_dict(self) -> dict:
        return {"ports": self.ports}

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

    def to_dict(self) -> dict:
        d: dict = {"protocol": self.protocol}
        for key in ("tcp", "udp", "sctp", "icmp", "icmpv6"):
            member = getattr(self, key)
            if member is not None:
                d[key] = member.to_dict()
        return d

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

    def to_dict(self) -> dict:
        return {"order": self.order, "protocolConfig": self.protocol_config.to_dict(),
                "action": self.action}

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

    def to_dict(self) -> dict:
        return {"sourceCIDRs": list(self.source_cidrs),
                "rules": [r.to_dict() for r in self.rules]}

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

    def to_dict(self) -> dict:
        return {
            "nodeSelector": {"matchLabels": dict(self.node_selector)},
            "ingress": [i.to_dict() for i in self.ingress],
            "interfaces": list(self.interfaces),
        }

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
    API_VERSION = "ingressnodefirewall.tpu/v1alpha1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: IngressNodeFirewallSpec = field(default_factory=IngressNodeFirewallSpec)

    def to_dict(self) -> dict:
        return {"apiVersion": self.API_VERSION, "kind": self.KIND,
                "metadata": self.metadata.to_dict(), "spec": self.spec.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "IngressNodeFirewall":
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata", {}) or {}),
            spec=IngressNodeFirewallSpec.from_dict(d.get("spec", {}) or {}),
        )


# --- IngressNodeFirewallNodeState -------------------------------------------


@dataclass
class IngressNodeFirewallNodeStateSpec:
    """interfaceIngressRules map (ingressnodefirewallnodestate_types.go:26-32)."""

    interface_ingress_rules: Dict[str, List[IngressNodeFirewallRules]] = field(
        default_factory=dict
    )

    def to_dict(self) -> dict:
        return {
            "interfaceIngressRules": {
                iface: [r.to_dict() for r in rules]
                for iface, rules in self.interface_ingress_rules.items()
            }
        }

    @classmethod
    def from_dict(cls, d: dict) -> "IngressNodeFirewallNodeStateSpec":
        return cls(
            interface_ingress_rules={
                iface: [IngressNodeFirewallRules.from_dict(r) for r in rules or []]
                for iface, rules in (d.get("interfaceIngressRules", {}) or {}).items()
            }
        )


@dataclass
class IngressNodeFirewallNodeStateStatus:
    """ingressnodefirewallnodestate_types.go:35-41."""

    sync_status: str = ""
    sync_error_message: str = ""

    def to_dict(self) -> dict:
        return {"syncStatus": self.sync_status, "syncErrorMessage": self.sync_error_message}

    @classmethod
    def from_dict(cls, d: dict) -> "IngressNodeFirewallNodeStateStatus":
        return cls(sync_status=d.get("syncStatus", ""),
                   sync_error_message=d.get("syncErrorMessage", ""))


@dataclass
class IngressNodeFirewallNodeState:
    """Per-node compiled desired state
    (ingressnodefirewallnodestate_types.go:58-64): what the daemon serves."""

    KIND = "IngressNodeFirewallNodeState"
    API_VERSION = "ingressnodefirewall.tpu/v1alpha1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: IngressNodeFirewallNodeStateSpec = field(
        default_factory=IngressNodeFirewallNodeStateSpec
    )
    status: IngressNodeFirewallNodeStateStatus = field(
        default_factory=IngressNodeFirewallNodeStateStatus
    )

    def to_dict(self) -> dict:
        return {
            "apiVersion": self.API_VERSION,
            "kind": self.KIND,
            "metadata": self.metadata.to_dict(),
            "spec": self.spec.to_dict(),
            "status": self.status.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "IngressNodeFirewallNodeState":
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata", {}) or {}),
            spec=IngressNodeFirewallNodeStateSpec.from_dict(d.get("spec", {}) or {}),
            status=IngressNodeFirewallNodeStateStatus.from_dict(d.get("status", {}) or {}),
        )


def deep_copy(obj):
    """Semantic deep copy of any spec dataclass (the reference's generated
    DeepCopy methods, api/v1alpha1/zz_generated.deepcopy.go)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return obj.__class__.from_dict(obj.to_dict())
    raise TypeError(f"deep_copy expects a spec dataclass, got {type(obj)!r}")


def semantic_equal(a, b) -> bool:
    """equality.Semantic.DeepEqual, as the controllers' update diffing uses
    it (ingressnodefirewall_controller.go:108,134)."""
    if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
        return a.to_dict() == b.to_dict()
    return a == b
