"""repro_torch.resilience - fault injection, guarded dispatch,
checkpoint/resume and input quarantine; the port's ``repro.resilience``.

  * ``faults``     - deterministic scripted failures at the dispatch seams
                     (env ``REPRO_TORCH_FAULTS``),
  * ``guard``      - retry with backoff for OOM, then the degradation
                     ladder blocked -> per event -> the CPU, with results
                     equal bit for bit; a strict classifier (only injected
                     faults degrade: a real OOM raises once its retries
                     are spent),
  * ``checkpoint`` - atomic carry snapshots between segments of a replay
                     (``checkpointed_replay``) and between chunks of a
                     streamed one (``StreamCheckpointer``), so a killed
                     ``sweep --resume`` continues bit for bit,
  * ``validate``   - malformed workload rows quarantined (counted), never
                     crashing a run; ``python -m repro_torch validate``.
"""
from . import checkpoint, faults, guard, validate
from .checkpoint import (ReplayCheckpointer, StreamCheckpointer,
                         checkpointed_replay, load_checkpoint,
                         save_checkpoint)
from .faults import (FAULT_KINDS, FaultPlan, FaultSpec, InjectedFault, fire,
                     parse_plan)
from .guard import (Rung, backoff_delay, guarded_call, is_degradable,
                    is_transient, replay_rungs, run_ladder, rung_label,
                    transition_name)
from .validate import (ValidationReport, sanitize_rows, validate_instance,
                       validate_rows)

__all__ = [
    "checkpoint", "faults", "guard", "validate",
    "ReplayCheckpointer", "StreamCheckpointer", "checkpointed_replay",
    "load_checkpoint", "save_checkpoint",
    "FAULT_KINDS", "FaultPlan", "FaultSpec", "InjectedFault", "fire",
    "parse_plan",
    "Rung", "backoff_delay", "guarded_call", "is_degradable",
    "is_transient", "replay_rungs", "run_ladder", "rung_label",
    "transition_name",
    "ValidationReport", "sanitize_rows", "validate_instance",
    "validate_rows",
]
