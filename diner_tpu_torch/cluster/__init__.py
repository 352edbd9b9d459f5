"""Cluster job layer for GPU nodes (port of diner_tpu.cluster)."""

from diner_tpu_torch.cluster.jobs import JobSpec, run_local, to_condor, to_jobset
from diner_tpu_torch.cluster.specs import SPECS

__all__ = ["JobSpec", "to_condor", "to_jobset", "run_local", "SPECS"]
