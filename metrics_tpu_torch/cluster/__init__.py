"""Cluster plane (port of ``metrics_tpu/cluster``): so far its error types,
which the query plane names among the refusals that leave a partition out of
a global answer. The coordination store, nodes and the client router follow
with the partition plane (ROADMAP A.9b).
"""

from metrics_tpu_torch.cluster.errors import ClusterConfigError, CoordStoreError, NoLeaderError

__all__ = ["ClusterConfigError", "CoordStoreError", "NoLeaderError"]
