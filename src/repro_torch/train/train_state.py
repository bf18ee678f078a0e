"""TrainState bundling params and optimizer state: the port of
``repro.train.train_state``."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.train.optimizer import Optimizer, apply_updates


class TrainState(NamedTuple):
    step: torch.Tensor
    params: Any
    opt_state: Any

    @classmethod
    def create(cls, params: Any, opt: Optimizer) -> "TrainState":
        return cls(torch.zeros((), dtype=torch.int32), params,
                   opt.init(params))

    def apply_gradients(self, grads: Any, opt: Optimizer) -> "TrainState":
        """One optimizer step; the params and moments are updated in
        place (``train.optimizer``), the step advanced."""
        updates, opt_state = opt.update(grads, self.opt_state, self.params)
        params = apply_updates(self.params, updates)
        return TrainState(self.step + 1, params, opt_state)
