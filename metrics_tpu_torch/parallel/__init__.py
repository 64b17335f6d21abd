"""Distributed state synchronisation (port of ``metrics_tpu/parallel``).

Replica-local accumulation + collective merge at compute: ``torch.distributed``
collectives on the states' own device inside a step, or the comm plane's host
path across processes.
"""

from metrics_tpu_torch.parallel.sync import in_trace, reduce_in_trace, sync_state_host, use_mesh

__all__ = ["in_trace", "reduce_in_trace", "sync_state_host", "use_mesh"]
