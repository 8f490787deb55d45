"""Serving: DVBP placement of requests on model replicas (``scheduler``),
the replica engine (``engine``) and the fleet simulation (``fleet``)."""
