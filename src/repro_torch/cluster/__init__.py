"""repro_torch.cluster - fleet-level job->host placement with failure
re-entry on the DVBP algorithm zoo (``placement``); the port's
``repro.cluster``."""
from .placement import ClusterScheduler, ClusterStats, Job, simulate_cluster

__all__ = ["ClusterScheduler", "ClusterStats", "Job", "simulate_cluster"]
