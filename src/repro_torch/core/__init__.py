"""MinUsageTime Dynamic Vector Bin Packing: instances, the algorithm zoo,
the exact oracle engine, prediction models, the Eq.(1) bound and the
batched replay (``torchsim``).

Public API (as the reference's ``repro.core``):
    Instance, Arrival, MigrantArrival, PackingResult   (types)
    run(instance, algorithm, ...)          (exact event-driven engine)
    lower_bound(instance), span(instance)  (Eq. 1 optimum lower bound)
    get_algorithm(name, **params)          (algorithm zoo registry)
    lognormal_predictions / uniform_predictions (error models)
"""
from .types import (EPS, Arrival, Instance, MigrantArrival,  # noqa: F401
                    PackingResult)
from .engine import run  # noqa: F401
from .lower_bound import lower_bound, span  # noqa: F401
from .metrics import BoxStats, summarize  # noqa: F401
from .predictions import (lognormal_predictions,  # noqa: F401
                          lognormal_predictions_batch, uniform_predictions,
                          uniform_predictions_batch)
from .algorithms import (ALL_ALGORITHMS, ANY_FIT, CLAIRVOYANT,  # noqa: F401
                         LEARNING_AUGMENTED, NON_CLAIRVOYANT, REGISTRY,
                         Algorithm, get_algorithm)
