"""Fault-tolerant training driver: checkpoint and restart, failure
injection, straggler mitigation, elastic re-meshing.  The counterpart of
``repro/runtime/driver.py``, with its schedule, its restore, NaN and
straggler semantics and its ``log`` events.

Failures are injected (:class:`FaultInjector`) so the recovery path runs
end to end: failure -> restore the latest checkpoint -> continue.  A step
whose loss is not finite counts as a failure too (restore, then replay).

Straggler mitigation: a step whose (simulated) slowest worker exceeds the
deadline drops a quarter of its batch and repeats the rest to fill it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .. import checkpoint as ckpt

__all__ = ["SimulatedFailure", "FaultInjector", "FaultTolerantTrainer",
           "elastic_remesh"]


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class FaultInjector:
    """Deterministic fault schedule: {step: kind} with kinds
    'crash' | 'nan' | 'straggler', each fired once."""
    schedule: Dict[int, str] = field(default_factory=dict)
    fired: set = field(default_factory=set)

    def check(self, step: int) -> Optional[str]:
        kind = self.schedule.get(step)
        if kind is not None and step not in self.fired:
            self.fired.add(step)
            return kind
        return None


@dataclass
class FaultTolerantTrainer:
    train_step: Callable  # (state, batch) -> (state, metrics)
    state: Any
    ckpt_dir: str
    ckpt_every: int = 10
    ckpt_codec: str = "none"
    injector: Optional[FaultInjector] = None
    step_deadline_s: Optional[float] = None
    max_restores: int = 8
    log: List[dict] = field(default_factory=list)

    def _save(self, step: int) -> None:
        ckpt.save(self.ckpt_dir, step, self.state, codec=self.ckpt_codec)

    def _restore_latest(self) -> int:
        last = ckpt.latest_step(self.ckpt_dir)
        if last is None:
            return 0
        self.state = ckpt.restore(self.ckpt_dir, last, self.state)
        return last

    def run(self, batches, num_steps: int) -> Any:
        """Run with recovery; ``batches`` must be indexable by step (so a
        restored run replays the right data)."""
        self._save(0)
        step = 0
        restores = 0
        while step < num_steps:
            kind = self.injector.check(step) if self.injector else None
            try:
                if kind == "crash":
                    raise SimulatedFailure(f"node failure at step {step}")
                t0 = time.time()
                batch = batches[step]
                if kind == "straggler" and self.step_deadline_s is not None:
                    # slow worker exceeded deadline: drop a microbatch slice
                    # and rescale (bounded-staleness gradient skip)
                    frac = 0.25
                    batch = {k: self._drop_and_rescale(v, frac)
                             for k, v in batch.items()}
                    self.log.append({"step": step, "event": "straggler_skip",
                                     "dropped_frac": frac})
                state, metrics = self.train_step(self.state, batch)
                loss = float(metrics["loss"])
                if kind == "nan" or not np.isfinite(loss):
                    raise SimulatedFailure(f"non-finite loss at step {step}")
                self.state = state
                self.log.append({"step": step, "loss": loss,
                                 "time_s": time.time() - t0})
                step += 1
                if step % self.ckpt_every == 0:
                    self._save(step)
            except SimulatedFailure as e:
                restores += 1
                if restores > self.max_restores:
                    raise
                resumed = self._restore_latest()
                self.log.append({"step": step, "event": "restore",
                                 "resumed_from": resumed, "cause": str(e)})
                step = resumed
        self._save(num_steps)
        return self.state

    @staticmethod
    def _drop_and_rescale(x, frac: float):
        """The first ``1 - frac`` of the rows, repeated to fill the
        batch."""
        b = x.shape[0]
        keep = max(int(b * (1 - frac)), 1)
        reps = int(np.ceil(b / keep))
        return np.concatenate([np.asarray(x[:keep])] * reps)[:b]


def elastic_remesh(old_mesh_devices: int, lost: int,
                   mesh_factory: Callable[[int], Any]):
    """Rebuild a mesh after losing hosts: shrink the data axis to the
    largest power of two that fits and hand it to ``mesh_factory``."""
    remaining = old_mesh_devices - lost
    new_data = 1
    while new_data * 2 <= remaining:
        new_data *= 2
    return mesh_factory(new_data)
