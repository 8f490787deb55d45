"""repro_torch.api - the one experiment API (the port's ``repro.api``).

The paper's whole empirical matrix is (workload x policy x information
setting) -> usage-time ratio; this package is the single public surface
for running any cell of it, batched, on the card (or, when the caller
passes ``device="cpu"``, on the CPU):

  * ``Policy`` - first-class policy objects (``Policy.parse`` /
    ``str(policy)`` round-trip, structured params, capability flags,
    ``policies()`` registry introspection).
  * ``Workload`` - synthetic suites (``synthetic``), the real Azure trace
    (``azure_trace``), prebuilt instances (``instances``), and serving
    request streams (``serving_requests`` - fleet capacity planning on
    the sweep engine).
  * ``Setting`` - nonclairvoyant / clairvoyant / predicted, made explicit;
    ``Setting.with_consolidation("underload:t0.25")`` attaches a
    ``ConsolidationSpec`` so the same regime replays with
    threshold-triggered migrations as a scenario axis.
  * ``Experiment`` / ``Results`` - the facade over the batched sweep
    engine with store-backed caching and Eq. (1) ratio summaries.

CLI: ``python -m repro_torch {sweep,serve}``.  Legacy entry points
(``sweep.grid.run_sweep``, ``serving.fleet.simulate_fleet``,
``python -m repro_torch.sweep``) remain as thin shims; grep
REPRO_API_MIGRATION for their breadcrumbs.
"""
from ..consolidate import ConsolidationSpec  # noqa: F401
from .policy import (CATEGORY_POLICIES, HOST_ONLY_POLICIES,  # noqa: F401
                     POLICIES, SCAN_POLICIES, Policy, policies,
                     policy_names)
from .workload import (AttachedPredictions, RuntimeWorkload,  # noqa: F401
                       Setting, SuiteWorkload, Workload, ZeroPredictions,
                       azure_trace, instances, requests_to_instance,
                       serving_requests, synthetic, workload)
from .experiment import (DEFAULT_STORE, Experiment, Results,  # noqa: F401
                         run_experiment, summarize_sweep)
from ._migration import warn_legacy  # noqa: F401
