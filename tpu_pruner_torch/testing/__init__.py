"""Hermetic test fixtures: fake Prometheus and fake Kubernetes API servers.

The reference has no mock metric backend at all — its query layer is tested
only via rendered-query assertions and its K8s layer only against a real
kind cluster (SURVEY.md §4). These fixtures close that gap: the full
pipeline (query → decode → resolve → scale) runs against local HTTP servers
with canned instant-vector responses and an in-memory object store that
applies real merge-patch semantics.
"""

from tpu_pruner_torch.testing.fake_k8s import FakeK8s
from tpu_pruner_torch.testing.fake_prom import FakePrometheus
from tpu_pruner_torch.testing.fake_proxy import FakeProxy

__all__ = ["FakeFleet", "FakeK8s", "FakePrometheus", "FakeProxy", "FleetMember"]


def __getattr__(name):
    # FakeFleet spawns the daemon binary; import it lazily so the plain
    # fakes stay importable without a built native tree.
    if name in ("FakeFleet", "FleetMember"):
        from tpu_pruner_torch.testing import fake_fleet

        return getattr(fake_fleet, name)
    raise AttributeError(name)
