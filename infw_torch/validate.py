"""Admission validation as a pure library.

Reimplements the reference's validating webhook (pkg/webhook/webhook.go)
without the k8s machinery: every check returns a list of human-readable
error strings; an empty list means the object is admitted.

Checks (webhook.go line refs):
- interface names: non-blank, <= IFNAMSIZ, no leading digit (:88-109);
- sourceCIDRs: at least one, each a valid CIDR (:138-153);
- rules: <= MAX_INGRESS_RULES (:245-251), unique order (:307-314), per-rule
  protocol-union shape (:260-305);
- Deny TCP/UDP rules may not cover failsafe ports; the range check is CLOSED
  [start, end] here (:316-318) even though the dataplane's range match is
  half-open [start, end) — an intentional asymmetry carried over as-is;
- cross-object: same nodeSelector + same sourceCIDR in a different
  IngressNodeFirewall must not have overlapping rule orders (:330-365).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from . import failsaferules, portutils, schema
from .netutil import validate_source_cidr
from .spec import (
    ACTION_ALLOW,
    PROTOCOL_TYPE_ICMP,
    PROTOCOL_TYPE_ICMP6,
    PROTOCOL_TYPE_SCTP,
    PROTOCOL_TYPE_TCP,
    PROTOCOL_TYPE_UDP,
    IngressNodeFirewall,
    IngressNodeFirewallProtocolRule,
)

IFNAMSIZ = 16


def validate_ingress_node_firewall(
    inf: IngressNodeFirewall,
    existing: Iterable[IngressNodeFirewall] = (),
) -> List[str]:
    """validateIngressNodeFirewall (webhook.go:74-86), preceded by the
    schema (OpenAPI/CEL) tier, which short-circuits as the API server's
    rejection does."""
    schema_errs = schema.validate_ingress_node_firewall_schema(inf)
    if schema_errs:
        return schema_errs
    errs = validate_inf_rules(inf, existing)
    if errs:
        return errs
    return validate_inf_interfaces(inf.spec.interfaces, inf.metadata.name)


def validate_inf_interfaces(interfaces: List[str], inf_name: str) -> List[str]:
    """validateINFInterfaces (webhook.go:88-109)."""
    errs: List[str] = []
    for index, iface in enumerate(interfaces):
        if iface == "":
            errs.append(
                f"spec.interfaces[{index}]: {inf_name}: can not use blank interface names"
            )
            continue
        if len(iface) > IFNAMSIZ:
            errs.append(
                f"spec.interfaces[{index}]: {inf_name}: interface {iface!r} is too long"
            )
        if iface[0].isdigit():
            errs.append(
                f"spec.interfaces[{index}]: {inf_name}: interface {iface!r} can't start with a number"
            )
    return errs


def validate_inf_rules(
    inf: IngressNodeFirewall, existing: Iterable[IngressNodeFirewall]
) -> List[str]:
    """validateINFRules (webhook.go:111-136)."""
    errs: List[str] = []
    existing = list(existing)
    for idx, ingress in enumerate(inf.spec.ingress):
        errs.extend(_validate_source_cidrs(ingress.source_cidrs, idx, inf.metadata.name))
        errs.extend(_validate_rules(ingress.rules, idx, inf.metadata.name))
        errs.extend(
            _validate_against_existing(
                existing,
                ingress.source_cidrs,
                ingress.rules,
                idx,
                inf.metadata.name,
                inf.spec.node_selector,
            )
        )
    return errs


def _validate_source_cidrs(
    source_cidrs: List[str], ingress_index: int, inf_name: str
) -> List[str]:
    """validatesourceCIDRs (webhook.go:138-153)."""
    errs: List[str] = []
    if len(source_cidrs) == 0:
        errs.append(
            f"spec.ingress[{ingress_index}].sourceCIDRs: {inf_name}: must be at least one sourceCIDRs"
        )
        return errs
    for cidr_index, cidr in enumerate(source_cidrs):
        reason = validate_source_cidr(cidr)
        if reason is not None:
            errs.append(
                f"spec.ingress[{ingress_index}].sourceCIDRs[{cidr_index}]: {inf_name}: "
                f"must be a valid IPV4 or IPV6 CIDR: {reason}"
            )
    return errs


def _validate_rules(
    rules: List[IngressNodeFirewallProtocolRule], ingress_index: int, inf_name: str
) -> List[str]:
    """validateRules (webhook.go:155-170)."""
    errs: List[str] = []
    if len(rules) > failsaferules.MAX_INGRESS_RULES:
        errs.append(
            f"spec.ingress[{ingress_index}].rules: {inf_name}: "
            f"must be no more than {failsaferules.MAX_INGRESS_RULES} rules"
        )
    if len({r.order for r in rules}) != len(rules):
        errs.append(
            f"spec.ingress[{ingress_index}].rules: {inf_name}: must have unique order"
        )
    for rule_index, rule in enumerate(rules):
        err = _validate_rule(rule, ingress_index, rule_index, inf_name)
        if err is not None:
            errs.append(err)
    return errs


def _validate_rule(
    rule: IngressNodeFirewallProtocolRule,
    ingress_index: int,
    rule_index: int,
    inf_name: str,
) -> Optional[str]:
    """validateRule (webhook.go:172-197)."""
    path = f"spec.ingress[{ingress_index}].rules[{rule_index}]: {inf_name}"
    proto = rule.protocol_config.protocol

    if proto in (PROTOCOL_TYPE_ICMP, PROTOCOL_TYPE_ICMP6):
        ok, reason = _is_valid_icmp_rule(rule)
        if not ok:
            return f"{path}: must be a valid ICMP(V6) rule: {reason}"

    if proto in (PROTOCOL_TYPE_TCP, PROTOCOL_TYPE_UDP, PROTOCOL_TYPE_SCTP):
        ok, reason = _is_valid_transport_rule(rule)
        if not ok:
            return f"{path}: must be a valid {proto} rule: {reason}"

    if proto in (PROTOCOL_TYPE_TCP, PROTOCOL_TYPE_UDP):
        conflict, err = _conflicts_with_failsafe(rule)
        if not conflict and err is not None:
            return f"{path}: must be a valid {proto} rule: {err}"
        if conflict and err is not None:
            return f"{path}: {err}"
    return None


def _conflicts_with_failsafe(
    rule: IngressNodeFirewallProtocolRule,
) -> Tuple[bool, Optional[str]]:
    """isConflictWithSafeRulesTransport (webhook.go:199-243)."""
    proto = rule.protocol_config.protocol
    if proto == PROTOCOL_TYPE_TCP:
        failsafe = failsaferules.get_tcp()
        r = rule.protocol_config.tcp
    elif proto == PROTOCOL_TYPE_UDP:
        failsafe = failsaferules.get_udp()
        r = rule.protocol_config.udp
    else:
        return False, f"unable to determine conflict rules for unknown protocol: {proto!r}"

    for fs in failsafe:
        if r is None:
            return False, "expected ports to be defined for transport protocol"
        # Allow rules over failsafe ports are fine (webhook.go:219-223).
        if rule.action == ACTION_ALLOW:
            continue
        try:
            if portutils.is_range(r):
                start, end = portutils.get_range(r)
                # Closed-interval check (webhook.go:316-318).
                if start <= fs.port <= end:
                    return True, f"port range is in conflict with access to {fs.service_name}"
            else:
                port = portutils.get_port(r)
                if port == fs.port:
                    return True, f"port is in conflict with access to {fs.service_name}"
        except portutils.PortParseError as e:
            return False, str(e)
    return False, None


def _is_valid_icmp_rule(rule: IngressNodeFirewallProtocolRule) -> Tuple[bool, str]:
    """isValidICMPICMPV6Rule (webhook.go:260-273)."""
    pc = rule.protocol_config
    if pc.protocol == PROTOCOL_TYPE_ICMP and (pc.icmp is None or pc.icmpv6 is not None):
        return False, "no ICMP rules defined. Define icmpType/icmpCode"
    if pc.protocol == PROTOCOL_TYPE_ICMP6 and (pc.icmpv6 is None or pc.icmp is not None):
        return False, "no ICMPv6 rules defined. Define icmpType/icmpCode"
    if pc.tcp is not None or pc.udp is not None or pc.sctp is not None:
        return False, "ports are erroneously defined"
    return True, ""


def _is_valid_transport_rule(rule: IngressNodeFirewallProtocolRule) -> Tuple[bool, str]:
    """isValidTCPUDPSCTPRule (webhook.go:275-305)."""
    pc = rule.protocol_config
    if pc.protocol == PROTOCOL_TYPE_TCP and pc.tcp is not None:
        r = pc.tcp
    elif pc.protocol == PROTOCOL_TYPE_UDP and pc.udp is not None:
        r = pc.udp
    elif pc.protocol == PROTOCOL_TYPE_SCTP and pc.sctp is not None:
        r = pc.sctp
    else:
        return False, "no port defined"

    try:
        if portutils.is_range(r):
            portutils.get_range(r)
        else:
            portutils.get_port(r)
    except portutils.PortParseError as e:
        return False, f"must be a valid port: {e}"

    if pc.icmp is not None or pc.icmpv6 is not None:
        return False, "ICMP type/code defined for a non-ICMP(V6) rule"
    return True, ""


def _validate_against_existing(
    existing: List[IngressNodeFirewall],
    new_source_cidrs: List[str],
    new_rules: List[IngressNodeFirewallProtocolRule],
    ingress_index: int,
    new_name: str,
    new_node_selector: dict,
) -> List[str]:
    """validateAgainstExistingINFs (webhook.go:330-365)."""
    errs: List[str] = []
    new_orders = {r.order for r in new_rules}
    for other in existing:
        if dict(other.spec.node_selector) != dict(new_node_selector):
            continue
        for other_ingress in other.spec.ingress:
            for other_cidr in other_ingress.source_cidrs:
                for new_cidr in new_source_cidrs:
                    if new_cidr.strip() != other_cidr.strip():
                        continue
                    # isOrderOverlapping (webhook.go:356-365)
                    if other.metadata.name != new_name and any(
                        r.order in new_orders for r in other_ingress.rules
                    ):
                        errs.append(
                            f"spec.ingress[{ingress_index}].rules: {new_name}: "
                            f"order is not unique for sourceCIDR {new_cidr!r} and "
                            f"conflicts with IngressNodeFirewall {other.metadata.name!r}"
                        )
    return errs
