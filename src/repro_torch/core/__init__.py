"""Instances, prediction models, the Eq.(1) lower bound and the batched
replay (``torchsim``)."""
from .types import EPS, Instance  # noqa: F401
from .lower_bound import lower_bound  # noqa: F401
from .metrics import BoxStats, summarize  # noqa: F401
from .predictions import (lognormal_predictions,  # noqa: F401
                          lognormal_predictions_batch, uniform_predictions,
                          uniform_predictions_batch)
