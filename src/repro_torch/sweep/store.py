"""Persist sweep results as JSON keyed by the spec's *suites* hash;
counterpart of ``repro.sweep.store``, in its exact file format, so a store
written by either package is read by the other.

One file per instance family set under the store root (default
``experiments/sweeps/``), named ``sweep_<suites_hash>.json``:

    {
      "schema": 2,
      "suites_hash": "<16 hex chars>",
      "checksum": "<16 hex chars over the results blob>",
      "spec": { ...canonical spec of the last run that wrote the file... },
      "results": { "<result_key>": { ...record... }, ... }
    }

Results are keyed per (suite, instance, policy, prediction model, seed) and
depend only on the suites, so specs that share suites share a file: an
interrupted sweep resumes, and an *extended* sweep (more policies,
prediction models, or seeds over the same suites) computes only the missing
groups.  ``run_sweep`` loads before running and saves after every completed
(suite, policy, prediction) group.

Resilience (this is long-running-job state, so corruption must not lose
the run):

  * the main file is written atomically (tmp + fsync + rename) and carries
    a content checksum; a truncated/corrupted/checksum-mismatched file is
    quarantined to a ``.corrupt`` sidecar (with a ``RuntimeWarning``)
    instead of raising - surviving state is rebuilt from the journal;
  * every completed group is ALSO appended to a ``.journal.jsonl``
    sidecar (one checksummed line per group delta, fsynced) *before* the
    main rewrite, so a crash mid-rewrite loses nothing: ``load`` unions
    journal records over the main blob, skipping torn tail lines;
  * loading the main file crosses the fault seam ``store.load`` and each
    save ends with ``store.save``, both with the file's ``path``, so the
    ``truncate`` fault kind can tear it (``resilience.faults``).

Multi-process safety (several sweep processes may share one store):
``save`` holds an exclusive ``flock`` on a ``.lock``
sidecar for the journal-append + main-rewrite critical section, and
rewrites the main blob as *on-disk state merged with this process's
records* rather than this process's view alone - so concurrent hosts
never clobber each other's groups, and the final file equals the
single-process result set.  Readers stay lock-free: the main file is
only ever atomically replaced, and torn journal tails are skipped.

Schema 1 files (no checksum, no journal) still load.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import tempfile
import warnings
from typing import Dict, Optional

try:
    import fcntl
except ImportError:          # non-POSIX: single-process stores still work
    fcntl = None

from .. import obs
from ..resilience import faults
from .grid import SweepSpec

SCHEMA_VERSION = 2


def _records_sha(results: Dict[str, Dict]) -> str:
    """Content checksum of a results mapping.  ``json.dumps`` of re-parsed
    floats is stable (repr round-trips), so the checksum computed on save
    equals the checksum recomputed on load."""
    blob = json.dumps(results, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


class SweepStore:
    def __init__(self, root: str = "experiments/sweeps"):
        self.root = root

    def path(self, spec: SweepSpec) -> str:
        return os.path.join(self.root, f"sweep_{spec.suites_hash()}.json")

    def journal_path(self, spec: SweepSpec) -> str:
        return self.path(spec) + ".journal.jsonl"

    # ------------------------------------------------------------- load

    def _load_main(self, spec: SweepSpec) -> Dict[str, Dict]:
        path = self.path(spec)
        if not os.path.exists(path):
            return {}
        faults.fire("store.load", path=path)
        try:
            with open(path) as f:
                blob = json.load(f)
            if blob.get("schema") not in (1, SCHEMA_VERSION):
                return {}
            if blob.get("suites_hash") != spec.suites_hash():
                return {}
            results = blob.get("results", {})
            if blob.get("schema") >= 2 and \
                    blob.get("checksum") != _records_sha(results):
                raise ValueError("store checksum mismatch")
            return results
        except (json.JSONDecodeError, ValueError, KeyError) as e:
            # torn write / bit rot: quarantine, warn, rebuild from the
            # journal instead of killing the sweep
            side = path + ".corrupt"
            os.replace(path, side)
            obs.counter_add("store.corrupt")
            warnings.warn(
                f"sweep store {path!r} is corrupt ({e}); quarantined to "
                f"{side!r}, rebuilding from the journal", RuntimeWarning,
                stacklevel=3)
            return {}

    def _load_journal(self, spec: SweepSpec) -> Dict[str, Dict]:
        """Union of every intact journal line's records (later lines win).
        A torn tail line (crash mid-append) is skipped, not fatal."""
        jpath = self.journal_path(spec)
        if not os.path.exists(jpath):
            return {}
        out: Dict[str, Dict] = {}
        with open(jpath) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    if rec.get("suites_hash") != spec.suites_hash():
                        continue
                    if rec.get("sha") != _records_sha(rec["records"]):
                        raise ValueError("journal line checksum mismatch")
                    out.update(rec["records"])
                    obs.counter_add("store.journal_records",
                                    len(rec["records"]))
                except (json.JSONDecodeError, ValueError, KeyError,
                        TypeError):
                    obs.counter_add("store.journal_skipped")
        return out

    def load(self, spec: SweepSpec) -> Dict[str, Dict]:
        # journal records are at least as fresh as the main blob (save
        # order is journal first, then main), so they are authoritative
        # when a crash interrupted the main rewrite
        results = self._load_main(spec)
        results.update(self._load_journal(spec))
        return results

    # ------------------------------------------------------------- save

    @contextlib.contextmanager
    def _locked(self, spec: SweepSpec):
        """Exclusive inter-process lock for the save critical section (a
        ``.lock`` sidecar never replaced, so the inode is stable)."""
        os.makedirs(self.root, exist_ok=True)
        if fcntl is None:
            yield
            return
        with open(self.path(spec) + ".lock", "a") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lf, fcntl.LOCK_UN)

    def _append_journal(self, spec: SweepSpec,
                        group_records: Dict[str, Dict]) -> None:
        jpath = self.journal_path(spec)
        line = json.dumps({"suites_hash": spec.suites_hash(),
                           "sha": _records_sha(group_records),
                           "records": group_records}, sort_keys=True)
        with open(jpath, "a") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())

    def save(self, spec: SweepSpec, results: Dict[str, Dict],
             group_records: Optional[Dict[str, Dict]] = None) -> str:
        path = self.path(spec)
        os.makedirs(self.root, exist_ok=True)
        with self._locked(spec):
            if group_records:
                # journal BEFORE the main rewrite: the delta survives a
                # crash at any point of the rewrite
                self._append_journal(spec, group_records)
            # merge over what is on disk, not over this process's view:
            # concurrent hosts interleave saves, and each must preserve
            # the groups the others have already landed
            merged = self._load_main(spec)
            merged.update(self._load_journal(spec))
            merged.update(results)
            blob = {"schema": SCHEMA_VERSION,
                    "suites_hash": spec.suites_hash(),
                    "checksum": _records_sha(merged),
                    "spec": spec.canonical(), "results": merged}
            # atomic replace so an interrupted sweep never corrupts it
            fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(blob, f, indent=1, sort_keys=True)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        # the seam after the replace: the "truncate" fault kind corrupts
        # the file just written, as a torn write would
        faults.fire("store.save", path=path)
        return path
