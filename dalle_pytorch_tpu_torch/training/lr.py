"""Host-side learning-rate controllers.

Counterpart of the JAX package's `training/lr.py`, copied:
`ReduceLROnPlateau` (factor 0.5, patience 10, cooldown 10, min_lr 1e-6;
the DALLE trainer steps it once an epoch on the averaged loss) and
`ExponentialDecay` (the dVAE trainer's). Both decide on host scalars and
return the new rate, which the trainer writes into the optimizer
(`training/steps.py:set_learning_rate`). Their `state_dict`s are the
JAX package's, so a checkpoint's scheduler state loads in either.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass


@dataclass
class ReduceLROnPlateau:
    factor: float = 0.5
    patience: int = 10
    cooldown: int = 10
    min_lr: float = 1e-6
    best: float = float("inf")
    num_bad: int = 0
    cooldown_counter: int = 0

    def step(self, metric: float, lr: float) -> float:
        """Feed the epoch metric; returns the (possibly reduced) lr."""
        if metric < self.best:
            self.best = metric
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                lr = max(lr * self.factor, self.min_lr)
                self.cooldown_counter = self.cooldown
                self.num_bad = 0
        return lr

    def state_dict(self) -> dict:
        return asdict(self)

    def load_state_dict(self, state: dict) -> None:
        for k, v in state.items():
            setattr(self, k, v)


@dataclass
class ExponentialDecay:
    gamma: float = 0.98

    def step(self, metric: float, lr: float) -> float:
        return lr * self.gamma

    def state_dict(self) -> dict:
        return asdict(self)

    def load_state_dict(self, state: dict) -> None:
        for k, v in state.items():
            setattr(self, k, v)
