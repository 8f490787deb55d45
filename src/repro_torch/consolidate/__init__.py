"""repro_torch.consolidate - threshold-triggered consolidation as a
scenario axis; counterpart of ``repro.consolidate``.

Operators repack as well as place: items migrate off nearly-empty bins so
those bins close earlier, trading migration churn for usage time.  Here:

  * a third event kind ``MIGRATE`` (``kernels.fitscore.MIGRATE_KIND``),
    replayed per event (``kernels.fitscore.replay_stepper``, the select
    with the source slot folded into its mask) and event-blocked (the
    megakernel ``csrc/replay_block.cu`` built with its MIGRATE branch):
    a full departure with the learning updates skipped, then the arrival
    machinery on the post-departure carry with the source slot kept out
    of the select's feasibility;
  * the numpy planner (:mod:`.planner`), a copy of the reference's, which
    reads the carry between replay chunks and emits MIGRATE events;
  * :class:`~.spec.ConsolidationSpec`, the knobs (none / underload drain /
    periodic sweep, load-fraction threshold, per-lane budget, cost,
    planning cadence), whose canonical strings equal the reference's;
  * :func:`~.driver.consolidated_replay`, chunked batched replay with the
    planner interleaved;
  * :func:`~.oracle.run_consolidating`, the sequential consolidating host
    oracle (float64, the host algorithm classes), which the chunked replay is held
    to decision for decision.

Churn counters: ``consolidate.migrations``, ``consolidate.bins_closed``,
``consolidate.budget_exhausted`` (see ``repro_torch.obs``).
"""
from .spec import ConsolidationSpec
from .planner import PlanResult, plan_migrations, should_plan
from .driver import consolidated_replay
from .oracle import run_consolidating

__all__ = ["ConsolidationSpec", "PlanResult", "plan_migrations",
           "should_plan", "consolidated_replay", "run_consolidating"]
