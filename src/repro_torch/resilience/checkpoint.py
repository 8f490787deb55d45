"""Checkpoint/resume for long replays: atomic snapshots of the replay's
carry; counterpart of ``repro.resilience.checkpoint``.

The carry of ``core.torchsim._replay_batch`` at any event boundary is the
whole replay state (slot loads, category state, running usage; the
per-event list or the blocked path's packed dict).  ``checkpointed_replay``
drives the same replay in segments of ``every_events`` events through the
port's carry hand-off (``_replay_batch(..., carry0=, return_carry=True,
ev_extra=)``), padding the tail with PAD events to a multiple of the
segment (itself a multiple of ``block_events``, so the blocked path cuts
the same blocks), and snapshots the carry between segments.  A killed run
resumes from the last snapshot with the same usage and bins bit for bit.

What segmenting must respect:

  * RCP's running distinct-category count is a cumsum over the *whole*
    event axis: it is computed once here on the full padded stream
    (``torchsim.replay_event_extras``) and sliced per segment.  Computing
    it per segment would restart the count and change decisions.
  * On the card each per-event segment is a call of its own, and a call
    captures its own CUDA graph (``torchsim.replay_windows``): every
    segment pays one eagerly run window and one capture.  Graphs are not
    kept across segments: the carry tensors are new after a resume.

Snapshot format: one ``.npz`` written to a temp file, fsynced, then
atomically renamed; it holds the carry's arrays (copied to the host), a
JSON header (the nesting of dicts / lists / tuples and the run's metadata)
and a content checksum.  Loading checks the checksum and that the metadata
matches the current run (policy, geometry, device type, ``migrate``, a
digest of the inputs): a torn snapshot is quarantined to a ``.corrupt``
sidecar (``resilience.ckpt_corrupt``) and a stale one left in place
(``resilience.ckpt_stale``); neither is trusted.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from .. import obs
from . import faults


def _pack(obj, leaves):
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, dict):
        keys = sorted(obj)
        return {"t": "dict", "k": keys,
                "v": [_pack(obj[k], leaves) for k in keys]}
    if isinstance(obj, (tuple, list)):
        return {"t": "tuple" if isinstance(obj, tuple) else "list",
                "v": [_pack(x, leaves) for x in obj]}
    leaves.append(obj.cpu().numpy() if torch.is_tensor(obj)
                  else np.asarray(obj))
    return {"t": "leaf", "i": len(leaves) - 1}


def _unpack(node, leaves):
    t = node["t"]
    if t == "none":
        return None
    if t == "dict":
        return {k: _unpack(v, leaves) for k, v in zip(node["k"], node["v"])}
    if t in ("tuple", "list"):
        seq = [_unpack(v, leaves) for v in node["v"]]
        return tuple(seq) if t == "tuple" else seq
    return leaves[node["i"]]


def _checksum(structure: dict, leaves) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(json.dumps(structure, sort_keys=True).encode())
    for a in leaves:
        h.update(str((a.shape, str(a.dtype))).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def to_device(tree, device):
    """A loaded snapshot's arrays as tensors on ``device`` (same nesting)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        seq = [to_device(v, device) for v in tree]
        return tuple(seq) if isinstance(tree, tuple) else seq
    if tree is None:
        return None
    return torch.from_numpy(np.array(tree)).to(device)


def save_checkpoint(path: str, carry, meta: dict) -> str:
    """Atomically snapshot a nest of arrays or tensors (copied to the
    host): tmp + fsync + rename, with a content checksum in the header."""
    leaves = []
    structure = _pack(carry, leaves)
    header = {"meta": meta, "structure": structure,
              "checksum": _checksum(structure, leaves)}
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __header__=np.array(json.dumps(header)),
                     **{f"leaf_{i}": a for i, a in enumerate(leaves)})
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    faults.fire("ckpt.save", path=path)
    return path


def load_checkpoint(path: str, expect_meta: Optional[dict] = None):
    """Load a snapshot: ``(tree of numpy arrays, meta)`` or None.

    None means "start from scratch": a missing file, a torn or corrupt one
    (checksum or parse failure; quarantined to ``path.corrupt``), or
    metadata that does not match ``expect_meta`` (a snapshot of another
    run; left in place, counted as stale)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            header = json.loads(str(z["__header__"].item()))
            leaves = [z[f"leaf_{i}"] for i in range(len(z.files) - 1)]
        if header["checksum"] != _checksum(header["structure"], leaves):
            raise ValueError("checkpoint checksum mismatch")
    except Exception as e:   # torn write, bad zip, bad json: quarantine
        os.replace(path, path + ".corrupt")
        obs.counter_add("resilience.ckpt_corrupt")
        obs.instant("resilience.ckpt_corrupt", path=path, error=str(e)[:200])
        return None
    meta = header["meta"]
    if expect_meta is not None and \
            any(meta.get(k) != v for k, v in expect_meta.items()):
        obs.counter_add("resilience.ckpt_stale")
        return None
    return _unpack(header["structure"], leaves), meta


def _safe(key: str) -> str:
    return "".join(c if c.isalnum() or c in "._-" else "-" for c in key)


# --------------------------------------------------------- segmented replay

@dataclasses.dataclass
class ReplayCheckpointer:
    """Where and how often to snapshot a segmented replay.

    ``every_events`` is the segment length (rounded up to a
    ``block_events`` multiple); ``resume=False`` ignores existing
    snapshots; ``keep=True`` leaves the last snapshot on disk after a
    completed run (by default it is deleted)."""

    root: str
    every_events: int = 2048
    resume: bool = True
    keep: bool = False

    def path_for(self, key: str) -> str:
        return os.path.join(self.root, f"ckpt_{_safe(key)}.npz")


def _input_digest(arrays, policy, max_bins, device_type, block_events,
                  seg: int, migrate: bool = False) -> str:
    h = hashlib.blake2b(digest_size=8)
    h.update(f"{policy}|{max_bins}|{device_type}|{block_events}|{seg}"
             f"|mig{int(migrate)}".encode())
    for a in arrays:
        if a is None:
            h.update(b"|none")
            continue
        a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        h.update(str((a.shape, str(a.dtype))).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def checkpointed_replay(arrays, *, policy: str, max_bins: int,
                        device="cuda", block_events: int = 0,
                        ckpt: ReplayCheckpointer, key: str,
                        migrate: bool = False):
    """Replay flattened lanes in checkpointed segments.

    ``arrays`` is the runner's flattened-lane tuple (sizes, times, kinds,
    items, pdeps (L, n_max), dmask, arrivals, rdeps, n_items).  Returns
    (usage (L,), opened (L,), placements (L, n_max), overflow (L,)) as
    tensors on ``device``, equal to the unsegmented ``_replay_batch``'s.
    ``migrate=True`` replays MIGRATE events; it is part of the snapshot
    digest, so a resume never mixes the two."""
    from ..core.torchsim import PAD_KIND, _replay_batch, replay_event_extras
    from ..kernels.ops import resolve_device
    dev = resolve_device(device)
    sizes, times, kinds, items, pdeps, dmask, arrivals, rdeps, n_items = \
        arrays
    times, kinds, items = (np.asarray(a) for a in (times, kinds, items))
    L, E = times.shape
    T = max(int(block_events), 1)
    seg = max(int(ckpt.every_events), T)
    seg = -(-seg // T) * T                 # block-multiple segments
    nseg = max(-(-E // seg), 1)
    pad = nseg * seg - E
    if pad:
        # PAD events leave the carry as it is, so padding the tail never
        # changes a decision
        times = np.concatenate([times, np.zeros((L, pad), times.dtype)], 1)
        kinds = np.concatenate(
            [kinds, np.full((L, pad), PAD_KIND, kinds.dtype)], 1)
        items = np.concatenate([items, np.zeros((L, pad), items.dtype)], 1)
    extras = replay_event_extras(policy, sizes, pdeps, dmask, arrivals,
                                 rdeps, n_items, times, kinds, items)
    digest = _input_digest(arrays, policy, max_bins, dev.type, block_events,
                           seg, migrate)
    path = ckpt.path_for(key)
    start, carry = 0, None
    if ckpt.resume:
        loaded = load_checkpoint(path, {"digest": digest})
        if loaded is not None:
            carry, meta = loaded
            carry = to_device(carry, dev)
            start = int(meta["next_seg"])
            obs.counter_add("resilience.ckpt_resume")
            obs.instant("resilience.ckpt_resume", key=key, seg=start)
    out = None
    for s in range(start, nseg):
        faults.fire("ckpt.segment")
        lo, hi = s * seg, (s + 1) * seg
        with obs.span("ckpt.segment", seg=s):
            usage, opened, placements, overflow, carry = _replay_batch(
                sizes, times[:, lo:hi], kinds[:, lo:hi], items[:, lo:hi],
                pdeps, dmask, arrivals, rdeps, n_items, policy=policy,
                max_bins=max_bins, device=dev, block_events=block_events,
                carry0=carry, return_carry=True,
                ev_extra=tuple(x[:, lo:hi] for x in extras),
                migrate=migrate)
        out = (usage, opened, placements, overflow)
        if s + 1 < nseg:
            # snapshot between segments: the carry is the whole replay
            # state, so a resume needs nothing else
            save_checkpoint(
                path, carry,
                {"digest": digest, "next_seg": s + 1, "policy": policy,
                 "max_bins": int(max_bins), "device": dev.type,
                 "block_events": int(block_events)})
            obs.counter_add("resilience.ckpt_save")
    if not ckpt.keep and os.path.exists(path):
        os.unlink(path)
    return out


# --------------------------------------------------------- streamed replay

@dataclasses.dataclass
class StreamCheckpointer:
    """Chunk-boundary snapshots for ``repro_torch.stream.replay_stream``.

    The streamed replay's whole state at a chunk boundary is (carry, row
    pool, chunk index): the host-side chunk builder is deterministic, so a
    resumed run rebuilds it by fast-forwarding the request stream to the
    snapshot's chunk, and no event array is ever saved.  The key covers
    the source's fingerprint and the replay's configuration (policy, pool
    size, device type, block and chunk geometry), so a snapshot of
    another stream or geometry is stale, never trusted.

    ``every_chunks`` is the cadence (each save waits for the device: the
    carry is copied to the host); ``keep=True`` leaves the last snapshot
    after a completed run."""

    root: str
    every_chunks: int = 8
    resume: bool = True
    keep: bool = False

    def key(self, fingerprint: str, *, policy: str, max_bins: int,
            device_type: str, block_events: int, chunk_events: int) -> str:
        h = hashlib.blake2b(digest_size=8)
        h.update(f"{fingerprint}|{policy}|{max_bins}|{device_type}"
                 f"|{block_events}|{chunk_events}".encode())
        return f"{policy}-{h.hexdigest()}"

    def path_for(self, key: str) -> str:
        return os.path.join(self.root, f"stream_{_safe(key)}.npz")

    def load(self, key: str):
        """(carry, pool, chunks_done) as numpy arrays from a matching
        snapshot, or None."""
        if not self.resume:
            return None
        loaded = load_checkpoint(self.path_for(key), {"digest": key})
        if loaded is None:
            return None
        state, meta = loaded
        obs.counter_add("resilience.stream_ckpt_resume")
        obs.instant("resilience.stream_ckpt_resume", key=key,
                    chunks=int(meta["chunks"]))
        return state["carry"], state["pool"], int(meta["chunks"])

    def maybe_save(self, key: str, carry, pool, chunks: int, *,
                   final: bool) -> None:
        path = self.path_for(key)
        if final:
            if not self.keep and os.path.exists(path):
                os.unlink(path)
            return
        if chunks % max(int(self.every_chunks), 1):
            return
        save_checkpoint(path, {"carry": carry, "pool": pool},
                        {"digest": key, "chunks": int(chunks)})
        obs.counter_add("resilience.stream_ckpt_save")
