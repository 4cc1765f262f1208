"""In-memory resource store: the control plane's "cluster API".

The reference's manager and daemon talk only through the Kubernetes API:
controllers List/Get/Create/Update/Delete typed objects and react to watch
events.  This is that surface as an in-memory, thread-safe store with watch
callbacks, what the daemon's NodeState controller runs against.

Semantics kept from the k8s client:
- objects are copied on write and on read (no aliasing mutations);
- deletes of finalized objects set ``deletion_timestamp`` and wait for
  finalizer removal (the NodeState finalizer dance,
  ingressnodefirewallnodestate_controller.go:77-99);
- every write bumps ``resource_version`` and fans out a watch event.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .spec import deep_copy

log = logging.getLogger("infw_torch.store")


class StoreError(RuntimeError):
    pass


class NotFoundError(StoreError):
    pass


class AlreadyExistsError(StoreError):
    pass


# watch event types
ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"

WatchCallback = Callable[[str, object], None]


def _copy(obj):
    return obj.__class__.from_dict(obj.to_dict())


class InMemoryStore:
    """Thread-safe object store with watches."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._objects: Dict[Tuple[str, str, str], object] = {}
        self._watchers: Dict[str, List[WatchCallback]] = {}
        self._rv = 0

    # -- keys ----------------------------------------------------------------

    @staticmethod
    def _key(kind: str, namespace: str, name: str) -> Tuple[str, str, str]:
        return (kind, namespace or "", name)

    def _key_of(self, obj) -> Tuple[str, str, str]:
        return self._key(obj.KIND, obj.metadata.namespace, obj.metadata.name)

    # -- reads ---------------------------------------------------------------

    def get(self, kind: str, name: str, namespace: str = ""):
        with self._lock:
            obj = self._objects.get(self._key(kind, namespace, name))
            if obj is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            return _copy(obj)

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        labels: Optional[Dict[str, str]] = None,
    ) -> List[object]:
        """List with optional namespace scoping and MatchingLabels
        selection (client.MatchingLabels semantics: empty selector matches
        everything)."""
        with self._lock:
            out = []
            for (k, ns, _), obj in sorted(self._objects.items()):
                if k != kind:
                    continue
                if namespace is not None and ns != (namespace or ""):
                    continue
                if labels:
                    meta = obj.metadata
                    if any(meta.labels.get(lk) != lv for lk, lv in labels.items()):
                        continue
                out.append(_copy(obj))
            return out

    # -- writes --------------------------------------------------------------

    def create(self, obj) -> object:
        with self._lock:
            key = self._key_of(obj)
            if key in self._objects:
                raise AlreadyExistsError(f"{key} already exists")
            stored = _copy(obj)
            # The API server ignores status on create (status is a
            # subresource).
            if hasattr(stored, "status"):
                stored.status = stored.status.__class__()
            self._rv += 1
            stored.metadata.resource_version = self._rv
            if not stored.metadata.uid:
                stored.metadata.uid = f"uid-{self._rv}"
            self._objects[key] = stored
            out = _copy(stored)
        self._notify(ADDED, stored)
        return out

    def update(self, obj) -> object:
        """Full-object update (spec + metadata); the status subresource is
        carried over from the stored object, mirroring the API server's
        split."""
        with self._lock:
            key = self._key_of(obj)
            cur = self._objects.get(key)
            if cur is None:
                raise NotFoundError(f"{key} not found")
            stored = _copy(obj)
            if hasattr(cur, "status"):
                stored.status = deep_copy(cur.status) if hasattr(cur.status, "to_dict") else cur.status
            stored.metadata.uid = cur.metadata.uid
            stored.metadata.deletion_timestamp = cur.metadata.deletion_timestamp
            # No-op updates don't bump the version or fire watches (API-server
            # semantics — this is what lets level-based reconciles that write
            # back unchanged state converge instead of livelocking).
            stored.metadata.resource_version = cur.metadata.resource_version
            if stored.to_dict() == cur.to_dict():
                return _copy(cur)
            self._rv += 1
            stored.metadata.resource_version = self._rv
            self._objects[key] = stored
            out = _copy(stored)
        self._notify(MODIFIED, stored)
        return out

    def delete(self, kind: str, name: str, namespace: str = "") -> None:
        """Finalizer-aware delete: objects with finalizers get a deletion
        timestamp and remain until the finalizers are removed via
        update_finalizers."""
        with self._lock:
            key = self._key(kind, namespace, name)
            cur = self._objects.get(key)
            if cur is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            if cur.metadata.finalizers:
                if cur.metadata.deletion_timestamp is None:
                    cur.metadata.deletion_timestamp = time.time()
                self._rv += 1
                cur.metadata.resource_version = self._rv
                event, obj = MODIFIED, cur
            else:
                del self._objects[key]
                event, obj = DELETED, cur
        # Re-notify even when deletion was already in progress: watchers
        # whose finalizer teardown failed transiently get a retry signal on
        # the next delete attempt (the role controller-runtime's requeue
        # plays for the reference).
        self._notify(event, obj)

    def update_finalizers(self, obj, finalizers: List[str]) -> object:
        """Set the finalizer list; an object past its deletion timestamp
        with no finalizers left is removed (API-server GC behavior the
        NodeState controller's finalizer dance relies on)."""
        with self._lock:
            key = self._key_of(obj)
            cur = self._objects.get(key)
            if cur is None:
                raise NotFoundError(f"{key} not found")
            cur.metadata.finalizers = list(finalizers)
            self._rv += 1
            cur.metadata.resource_version = self._rv
            if cur.metadata.deletion_timestamp is not None and not cur.metadata.finalizers:
                del self._objects[key]
                event = DELETED
            else:
                event = MODIFIED
            out = _copy(cur)
        self._notify(event, cur)
        return out

    # -- watches -------------------------------------------------------------

    def watch(self, kind: str, callback: WatchCallback) -> Callable[[], None]:
        """Subscribe to events for a kind; returns an unsubscribe thunk."""
        with self._lock:
            self._watchers.setdefault(kind, []).append(callback)

        def cancel() -> None:
            with self._lock:
                try:
                    self._watchers.get(kind, []).remove(callback)
                except ValueError:
                    pass

        return cancel

    def _notify(self, event: str, obj) -> None:
        """Fan out an event.  Callers invoke this OUTSIDE the store lock so
        slow watchers (a full dataplane sync can sleep through attach
        retries) never block other threads' store access."""
        with self._lock:
            callbacks = list(self._watchers.get(obj.KIND, []))
        for cb in callbacks:
            # A raising watcher must not propagate into the writer's
            # create/update call or skip the remaining watchers (mirrors
            # controller-runtime's per-handler workqueue isolation).
            try:
                cb(event, _copy(obj))
            except Exception:
                log.exception("watch callback failed for %s %s", event, obj.KIND)
