"""Schema-tier (OpenAPI/CEL) validation for the IngressNodeFirewall CR.

The reference enforces these invariants before its webhook runs, generated
from the validation markers on the API types
(api/v1alpha1/ingressnodefirewall_types.go):

- protocol Enum "ICMP";"ICMPv6";"TCP";"UDP";"SCTP";"" (:61)
- the five protocol-union XValidation (CEL) rules (:51-56)
- order Required + Minimum 1 (:93-97)
- icmpType / icmpCode Minimum 0 / Maximum 255 (:26-38)
- action Enum "Allow";"Deny" (:128-130)
"""
from __future__ import annotations

from typing import List

from .spec import (
    ACTION_ALLOW,
    ACTION_DENY,
    PROTOCOL_TYPE_ICMP,
    PROTOCOL_TYPE_ICMP6,
    PROTOCOL_TYPE_SCTP,
    PROTOCOL_TYPE_TCP,
    PROTOCOL_TYPE_UDP,
    PROTOCOL_TYPE_UNSET,
    IngressNodeFirewall,
    IngressNodeFirewallNodeState,
    IngressNodeFirewallProtocolRule,
)

PROTOCOL_ENUM = (
    PROTOCOL_TYPE_ICMP,
    PROTOCOL_TYPE_ICMP6,
    PROTOCOL_TYPE_TCP,
    PROTOCOL_TYPE_UDP,
    PROTOCOL_TYPE_SCTP,
    PROTOCOL_TYPE_UNSET,
)

ACTION_ENUM = (ACTION_ALLOW, ACTION_DENY)

# The five union XValidation rules (types.go:52-56): discriminator value ->
# (member attribute, CEL message).
_UNION_MEMBERS = (
    (PROTOCOL_TYPE_TCP, "tcp", "tcp is required when protocol is TCP, and forbidden otherwise"),
    (PROTOCOL_TYPE_UDP, "udp", "udp is required when protocol is UDP, and forbidden otherwise"),
    (PROTOCOL_TYPE_SCTP, "sctp", "sctp is required when protocol is SCTP, and forbidden otherwise"),
    (PROTOCOL_TYPE_ICMP, "icmp", "icmp is required when protocol is ICMP, and forbidden otherwise"),
    (PROTOCOL_TYPE_ICMP6, "icmpv6", "icmpv6 is required when protocol is ICMPv6, and forbidden otherwise"),
)


def _enum_msg(value, supported) -> str:
    sup = ", ".join(f'"{s}"' for s in supported)
    return f'Unsupported value: "{value}": supported values: {sup}'


def validate_rule_schema(
    rule: IngressNodeFirewallProtocolRule, path: str
) -> List[str]:
    """Schema checks for one IngressNodeFirewallProtocolRule at `path`
    (e.g. ``spec.ingress[0].rules[2]``)."""
    errs: List[str] = []

    if rule.order < 1:
        errs.append(
            f"{path}.order: Invalid value: {rule.order}: "
            f"{path}.order in body should be greater than or equal to 1"
        )

    pc = rule.protocol_config
    if pc.protocol not in PROTOCOL_ENUM:
        errs.append(
            f"{path}.protocolConfig.protocol: {_enum_msg(pc.protocol, PROTOCOL_ENUM)}"
        )
    else:
        # The union rules only apply once the discriminator is legal.
        for proto, attr, message in _UNION_MEMBERS:
            member = getattr(pc, attr)
            required = pc.protocol == proto
            if required != (member is not None):
                errs.append(f"{path}.protocolConfig: Invalid value: \"object\": {message}")

    for attr in ("icmp", "icmpv6"):
        member = getattr(pc, attr)
        if member is None:
            continue
        for fname, val in (("icmpType", member.icmp_type), ("icmpCode", member.icmp_code)):
            if not 0 <= val <= 255:
                bound = (
                    "less than or equal to 255"
                    if val > 255
                    else "greater than or equal to 0"
                )
                errs.append(
                    f"{path}.protocolConfig.{attr}.{fname}: Invalid value: {val}: "
                    f"{path}.protocolConfig.{attr}.{fname} in body should be {bound}"
                )

    if rule.action not in ACTION_ENUM:
        errs.append(f"{path}.action: {_enum_msg(rule.action, ACTION_ENUM)}")
    return errs


def validate_ingress_node_firewall_schema(inf: IngressNodeFirewall) -> List[str]:
    """All schema-tier errors for an IngressNodeFirewall object."""
    errs: List[str] = []
    for i, ingress in enumerate(inf.spec.ingress):
        # sourceCIDRs MinItems:=1 (types.go:141-143).
        if len(ingress.source_cidrs) == 0:
            errs.append(
                f"spec.ingress[{i}].sourceCIDRs: Invalid value: 0: "
                f"spec.ingress[{i}].sourceCIDRs in body should have at least 1 items"
            )
        for r, rule in enumerate(ingress.rules):
            errs.extend(validate_rule_schema(rule, f"spec.ingress[{i}].rules[{r}]"))
    return errs


def validate_nodestate_schema(ns: IngressNodeFirewallNodeState) -> List[str]:
    """Schema-tier errors for a NodeState, which embeds the same rule types
    (ingressnodefirewallnodestate_types.go:26-32).  Applied by the daemon's
    state-dir file protocol (daemon.Daemon.scan_nodestates_once), which has
    no API server in front of it."""
    errs: List[str] = []
    for iface, rule_sets in sorted(ns.spec.interface_ingress_rules.items()):
        for i, ingress in enumerate(rule_sets):
            path = f"spec.interfaceIngressRules[{iface}][{i}]"
            # sourceCIDRs MinItems:=1 (types.go:141-143), the same embedded type
            if len(ingress.source_cidrs) == 0:
                errs.append(
                    f"{path}.sourceCIDRs: Invalid value: 0: "
                    f"{path}.sourceCIDRs in body should have at least 1 items"
                )
            for r, rule in enumerate(ingress.rules):
                errs.extend(validate_rule_schema(rule, f"{path}.rules[{r}]"))
    return errs
