"""Daemon-side NodeState controller.

The counterpart of the reference's
controllers/ingressnodefirewallnodestate_controller.go:
filters reconcile requests to this node's own name + namespace (:62-64),
maintains the finalizer so in-flight deletions detach the dataplane before
the object disappears (:77-99), and delegates the actual work to the
one-method syncer boundary (:112-123).  The module-level ``mock`` variable
is the same test-injection seam the reference uses (:112-113).
"""
from __future__ import annotations

import logging
from typing import Optional

from .spec import IngressNodeFirewallNodeState
from .store import InMemoryStore, NotFoundError
from .syncer import Syncer, SyncError

log = logging.getLogger("infw_torch.nodestate")

# ingressNodeFirewallFinalizer (ingressnodefirewallnodestate_controller.go:42)
INGRESS_NODE_FIREWALL_FINALIZER = "ingressnodefirewall.tpu/finalizer"

# mock shall be None for production but can be overwritten for mock tests
# (ingressnodefirewallnodestate_controller.go:112-113).
mock: Optional[Syncer] = None


class NodeStateReconciler:
    def __init__(
        self,
        store: InMemoryStore,
        syncer: Syncer,
        node_name: str,
        namespace: str = "ingress-node-firewall-system",
    ) -> None:
        self.store = store
        self.syncer = syncer
        self.node_name = node_name
        self.namespace = namespace

    def reconcile(self, name: str, namespace: str) -> None:
        """Reconcile (:58-104)."""
        if name != self.node_name or namespace != self.namespace:
            return
        try:
            node_state = self.store.get(
                IngressNodeFirewallNodeState.KIND, name, namespace
            )
        except NotFoundError:
            return  # deletion already handled (:68-75)

        if node_state.metadata.deletion_timestamp is not None:
            if INGRESS_NODE_FIREWALL_FINALIZER in node_state.metadata.finalizers:
                self.reconcile_resource(node_state, is_delete=True)
                finalizers = [
                    f
                    for f in node_state.metadata.finalizers
                    if f != INGRESS_NODE_FIREWALL_FINALIZER
                ]
                self.store.update_finalizers(node_state, finalizers)
            return

        if INGRESS_NODE_FIREWALL_FINALIZER not in node_state.metadata.finalizers:
            self.store.update_finalizers(
                node_state,
                node_state.metadata.finalizers + [INGRESS_NODE_FIREWALL_FINALIZER],
            )

        log.info(
            "Reconciling resource and programming dataplane name=%s namespace=%s",
            name, namespace,
        )
        self.reconcile_resource(node_state, is_delete=False)

    def reconcile_resource(
        self, node_state: IngressNodeFirewallNodeState, is_delete: bool
    ) -> None:
        """reconcileResource (:115-123)."""
        syncer = mock if mock is not None else self.syncer
        try:
            syncer.sync_interface_ingress_rules(
                node_state.spec.interface_ingress_rules, is_delete
            )
        except SyncError as e:
            raise SyncError(f"FailedToSyncIngressNodeFirewallResources: {e}") from e
