# Copied from gatekeeper_tpu/control/upgrade.py; unchanged.
"""Stored-version upgrade manager.

Mirrors pkg/upgrade/manager.go (:80 `upgrade`, :94 `upgradeGroupVersion`):
on process start, every gatekeeper object still stored at a deprecated
API version is touched with a no-op update so the store re-serializes it
at the preferred version. The reference walks
`constraints.gatekeeper.sh/v1alpha1` and `templates.gatekeeper.sh/
v1alpha1` via the discovery client and issues empty updates; here the
cluster abstraction re-applies each object at the preferred version and
removes the deprecated-version entry (the FakeCluster keys objects by
GVK, so a version bump is a move).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .events import GVK

# (group, deprecated version) -> preferred version
UPGRADE_GROUPS: Dict[Tuple[str, str], str] = {
    ("templates.gatekeeper.sh", "v1alpha1"): "v1beta1",
    ("constraints.gatekeeper.sh", "v1alpha1"): "v1beta1",
}


class UpgradeManager:
    def __init__(self, cluster):
        self.cluster = cluster
        self.upgraded: List[str] = []

    def upgrade(self) -> int:
        """Migrate every object of the deprecated group-versions to the
        preferred version; returns the number migrated."""
        n = 0
        for gvk in list(self.cluster.known_gvks()):
            preferred = UPGRADE_GROUPS.get((gvk.group, gvk.version))
            if preferred is None:
                continue
            pref_gvk = GVK(gvk.group, preferred, gvk.kind)
            for obj in list(self.cluster.list(gvk)):
                meta = obj.get("metadata") or {}
                ns = meta.get("namespace") or ""
                name = meta.get("name") or ""
                # never clobber an object already stored at the
                # preferred version — it is newer by definition; just
                # drop the stale deprecated copy
                if self.cluster.get(pref_gvk, ns, name) is None:
                    new = dict(obj)
                    new["apiVersion"] = f"{gvk.group}/{preferred}"
                    self.cluster.apply(new)
                self.cluster.delete(gvk, ns, name)
                self.upgraded.append(
                    f"{gvk}/{meta.get('name', '')}"
                )
                n += 1
        return n
