"""One-line, once-per-process deprecation breadcrumbs for legacy entry
points that now shim onto ``repro_torch.api`` (the port's
``repro.api._migration``).

Kept import-free (stdlib only) so legacy modules can call it without
creating an import cycle with the api package.  Every message carries the
grep-able ``REPRO_API_MIGRATION`` tag.
"""
from __future__ import annotations

import warnings
from typing import Set

_WARNED: Set[str] = set()


def warn_legacy(old: str, new: str) -> None:
    """Emit the migration warning for ``old`` once per process."""
    if old in _WARNED:
        return
    _WARNED.add(old)
    warnings.warn(
        f"REPRO_API_MIGRATION: {old} is a legacy entry point kept as a "
        f"thin shim; use {new} (see repro_torch.api)",
        DeprecationWarning, stacklevel=3)
