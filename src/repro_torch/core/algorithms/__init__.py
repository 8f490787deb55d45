"""The DVBP algorithm zoo of the port: the host (numpy, float64) policies
of the registry, and the item classifiers of the category-structured
policies in float32 torch (the replay's).  Importing this package
populates the registry.

The host policies are the reference's classes (``repro.core.algorithms``),
copied module for module: ``anyfit`` (First Fit, MRU, Best Fit, Next Fit,
Round-Robin Next Fit), ``departure`` (CBDT, the two NRT policies, Greedy),
``duration`` (CBD, Hybrid, Reduced Hybrid and their direct-sum variants),
``learned`` (RCP, PPE, their modified variants, Lifetime Alignment) and
``adaptive`` (the adaptive switch and the departure-error estimator that
PPE shares).  The oracle engine (``core.engine.run``), the consolidating
oracle and the serving scheduler bind them.

The classifiers below are the port's copy of the jnp twins in the
reference's ``duration``, ``learned``, ``adaptive`` and ``departure``
modules; the replay (``core.torchsim``) imports them from here.  Each
function is the same fp32 op sequence as its jnp twin, so the replay puts
every item in the same category as the JAX package's scan.  Power-of-two
class boundaries come from ``torch.frexp`` (exact), as the reference's
come from ``jnp.frexp``.  Two of XLA's rewrites are reproduced: its
float-to-int32 casts saturate (``to_i32``), and it compiles a division by
a constant into a product with the constant's float32 reciprocal
(``_div_const``), which rounds differently from the division.
"""
from __future__ import annotations

import math

import torch

from .base import REGISTRY, Algorithm, get_algorithm, register  # noqa: F401
from . import adaptive, anyfit, departure, duration, learned  # noqa: F401
from .learned import LA_BINARY_SPLIT

ALL_ALGORITHMS = sorted(REGISTRY)

NON_CLAIRVOYANT = ["first_fit", "mru", "next_fit", "rr_next_fit", "best_fit"]
CLAIRVOYANT = ["cbdt", "nrt_standard", "nrt_prioritized", "greedy", "cbd",
               "hybrid", "reduced_hybrid", "hybrid_direct_sum",
               "reduced_hybrid_direct_sum"]
LEARNING_AUGMENTED = ["rcp", "ppe", "rcp_modified", "ppe_modified",
                      "lifetime_alignment"]
# Any Fit algorithms (never open a new bin when the item fits in an open bin)
ANY_FIT = ["first_fit", "mru", "rr_next_fit", "best_fit_l1", "best_fit_l2",
           "best_fit_linf", "nrt_standard", "nrt_prioritized", "greedy",
           "la_binary", "la_geometric"]

_I32_MAX, _I32_MIN = 2 ** 31 - 1, -2 ** 31


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 as XLA converts: truncation, saturating at the int32
    range, NaN to 0 (torch's own cast is undefined out of range)."""
    big = x >= 2.0 ** 31
    small = x < -2.0 ** 31
    safe = torch.where(big | small | torch.isnan(x), 0.0, x)
    out = safe.to(torch.int32)
    out = torch.where(big, _I32_MAX, out)
    return torch.where(small, _I32_MIN, out).to(torch.int32)


def _div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a Python constant ``c`` as the reference's jitted code
    computes it: ``x * (1 / c)``, the reciprocal rounded to float32."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return x * (one / torch.tensor(c, dtype=torch.float32))


def dur_exponent_jnp(dur: torch.Tensor) -> torch.Tensor:
    """j with dur in [2^(j-1), 2^j), int32, exact via frexp."""
    return torch.frexp(torch.clamp_min(dur, 1e-12))[1].to(torch.int32)


def duration_class_jnp(dur: torch.Tensor, beta: float = 2.0) -> torch.Tensor:
    """CBD class i with dur in [beta^(i-1), beta^i).  beta == 2 is the
    exact frexp path; other bases take the f32 log ratio, as the reference
    does (``floor(log(dur) / log(beta)) + 1``)."""
    if beta == 2.0:
        return dur_exponent_jnp(dur)
    dur = torch.clamp_min(dur, 1e-12)
    return to_i32(torch.floor(_div_const(torch.log(dur), math.log(beta))) +
                  1)


def hybrid_threshold_jnp(i: torch.Tensor) -> torch.Tensor:
    """General-vs-category routing threshold 1/(2 sqrt(i)), f32."""
    return 1.0 / (2.0 * torch.sqrt(i.to(torch.float32)))


def geo_class_jnp(dur: torch.Tensor) -> torch.Tensor:
    """0 if dur < 1 s, else i with dur in [2^(i-1), 2^i) seconds."""
    return torch.where(dur < 1.0, 0, dur_exponent_jnp(dur)).to(torch.int32)


def la_class_jnp(dur: torch.Tensor, mode: str = "binary") -> torch.Tensor:
    """Lifetime Alignment class of a (predicted or remaining) duration."""
    if mode == "binary":
        return (dur >= LA_BINARY_SPLIT).to(torch.int32)
    return geo_class_jnp(dur)


def prediction_error_jnp(rdur: torch.Tensor,
                         pdur: torch.Tensor) -> torch.Tensor:
    """Multiplicative misprediction max(rdur/pdur, pdur/rdur)."""
    pdur = torch.clamp_min(pdur, 1e-12)
    return torch.maximum(rdur / pdur, pdur / rdur)


def pow2_ceiling_jnp(x: torch.Tensor) -> torch.Tensor:
    """Smallest power of two >= x, exact via frexp."""
    m, e = torch.frexp(x)
    return torch.ldexp(torch.where(m == 0.5, 0.5, 1.0).to(x.dtype), e)


def departure_window_jnp(pdep: torch.Tensor, rho: float) -> torch.Tensor:
    """CBDT class: index of the rho-wide window holding a departure."""
    return to_i32(torch.floor(_div_const(pdep, rho)))
