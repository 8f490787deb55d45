"""Elastic training: a failure, a re-attach to the surviving device, an
exact resume - the port's ``repro.train.elastic``.

The trainer checkpoints every ``ckpt_every`` steps (and at the end of a
run).  When a step fails, a new trainer over the same checkpoint directory
is attached to a device that is still there (the card, another card, or
the CPU), restores the newest checkpoint onto it and replays the data
stream from that step: the stream is seekable (batch = pure_fn(step)), so
the resumed run takes the same batches as one that never failed.
Checkpoints are the reference's layout (``train.checkpoint``), so a run
checkpointed by either package resumes in the other.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .checkpoint import CheckpointManager


@dataclasses.dataclass
class ElasticConfig:
    ckpt_every: int = 10
    keep: int = 2


class ElasticTrainer:
    """Runs train steps with checkpoint and restart across devices.

    ``make_state(device)`` builds a fresh state (a tree of tensors) on
    ``device``; ``make_step(device)`` returns ``(step_fn, None)``, where
    ``step_fn`` maps (state, batch) -> (state, metrics) on that device (the
    reference's second item, the mesh's shardings, has no counterpart);
    ``batch_fn(step)`` deterministically produces the global batch, whose
    leaves the trainer moves to the device.
    """

    def __init__(self, make_state: Callable, make_step: Callable,
                 batch_fn: Callable[[int], dict], ckpt_dir: str,
                 cfg: ElasticConfig = ElasticConfig()):
        self.make_state = make_state
        self.make_step = make_step
        self.batch_fn = batch_fn
        self.cfg = cfg
        self.ckpt = CheckpointManager(ckpt_dir, keep=cfg.keep,
                                      async_save=False)
        self.step = 0
        self.state = None
        self.device: Optional[torch.device] = None
        self._fn = None

    def attach(self, device) -> None:
        """(Re)build on ``device``: restore the newest checkpoint there if
        there is one, else a fresh state."""
        self.device = torch.device(device)
        self._fn, _ = self.make_step(self.device)
        # a fresh state; a restore takes its leaves' shapes, dtypes and
        # device from it
        self.state = self.make_state(self.device)
        self.step = 0
        if self.ckpt.latest_step() is not None:
            self.step, self.state = self.ckpt.restore(self.state)

    def run(self, n_steps: int, fail_at: Optional[int] = None):
        """Run steps; simulate a failure by raising at ``fail_at``."""
        metrics = None
        target = self.step + n_steps
        while self.step < target:
            if fail_at is not None and self.step == fail_at:
                raise RuntimeError(f"simulated node failure at {self.step}")
            batch = {k: torch.as_tensor(v).to(self.device)
                     for k, v in self.batch_fn(self.step).items()}
            self.state, metrics = self._fn(self.state, batch)
            self.step += 1
            if self.step % self.cfg.ckpt_every == 0:
                self.ckpt.save(self.step, self.state)
        self.ckpt.save(self.step, self.state)
        return metrics
