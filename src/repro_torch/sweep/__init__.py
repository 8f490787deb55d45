"""Batched experiment sweeps on the card: batching, the batched runner,
declarative grids and the result store (the reference's file format).

CLI: ``python -m repro_torch sweep --help``."""
from .batching import InstanceBatch, pack_instances, pad_predictions  # noqa: F401
from .runner import BatchRunResult, run_batch, run_grid  # noqa: F401
from .grid import (PredModel, SuiteSpec, SweepSpec, result_key,  # noqa: F401
                   run_sweep, summarize_sweep)
from .store import SweepStore  # noqa: F401
