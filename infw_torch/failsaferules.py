"""Cluster-failsafe port protection list.

Mirrors the reference's pkg/failsaferules/failsaferules.go:3-63: hardcoded
transport ports that Deny rules may never cover, and the MAX_INGRESS_RULES
limit shared with the webhook.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

MAX_INGRESS_RULES = 100


@dataclass(frozen=True)
class TransportProtoFailSafeRule:
    service_name: str
    port: int


_TCP: List[TransportProtoFailSafeRule] = [
    TransportProtoFailSafeRule("Kubernetes API", 6443),
    TransportProtoFailSafeRule("ETCD", 2380),
    TransportProtoFailSafeRule("ETCD", 2379),
    TransportProtoFailSafeRule("SSH", 22),
    TransportProtoFailSafeRule("Kubelet", 10250),
    TransportProtoFailSafeRule("kube-scheduler", 10259),
    TransportProtoFailSafeRule("kube-controller-manager", 10257),
]

_UDP: List[TransportProtoFailSafeRule] = [
    TransportProtoFailSafeRule("DHCP", 68),
]


def get_tcp() -> List[TransportProtoFailSafeRule]:
    return list(_TCP)


def get_udp() -> List[TransportProtoFailSafeRule]:
    return list(_UDP)
