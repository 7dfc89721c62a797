"""Adaptive fanout scheduling — the paper's second §5 future-work item
(counterpart of ``repro.core.adaptive``).

"we can use an adaptive fanout schedule to dynamically adjust the sampling
 fanouts based on the training dynamics"

The schedule is a stage ladder: training starts at the full fanouts and
steps down a rung whenever the loss plateaus (relative improvement below
``threshold`` for ``patience`` epochs).  A rung change means a step built
at the new fanouts (``Pipeline.from_layout`` with a spec whose sampler
carries ``fanouts``), so a run builds at most ``len(ladder)`` steps.
Late-training epochs then sample far fewer neighbours per step, which is
where most of the sampling time goes.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class AdaptiveFanout:
    ladder: tuple[tuple[int, ...], ...] = ((15, 10, 5), (10, 7, 4),
                                           (5, 5, 3))
    patience: int = 2
    threshold: float = 0.01          # relative improvement to count as such

    stage: int = 0
    _best: float = float("inf")
    _stall: int = 0

    @property
    def fanouts(self) -> tuple[int, ...]:
        return self.ladder[self.stage]

    @property
    def edges_per_seed(self) -> int:
        """Sampled edges per seed at the current rung: F_1 + F_1 F_2 +
        ..."""
        total, width = 0, 1
        for f in self.fanouts:
            width *= f
            total += width
        return total

    def update(self, epoch_loss: float) -> bool:
        """Feed one epoch loss; returns True when the stage just changed
        (the caller builds its step at the new ``fanouts``)."""
        if epoch_loss < self._best * (1 - self.threshold):
            self._best = epoch_loss
            self._stall = 0
            return False
        self._stall += 1
        if self._stall >= self.patience and self.stage < len(self.ladder) - 1:
            self.stage += 1
            self._stall = 0
            self._best = epoch_loss
            return True
        return False
