"""Small MLPs for the scheduler agents (paper §V-A: two ReLU hidden layers
of 128 and 64 units); the port of ``repro.core.networks``.

Weights are stored ``(in, out)`` and applied as ``x @ w + b``, the
reference's layout, so its nets cross over without a transpose.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

HIDDEN = (128, 64)


class MLP(nn.Module):
    """ReLU MLP ``in_dim -> *hidden -> out_dim``. He-normal weights
    (std ``sqrt(2 / fan_in)``, the last layer's times ``out_scale``) drawn
    from ``generator`` and zero biases, as the reference's ``mlp_init``;
    the values differ from ``jax.random``'s."""

    def __init__(self, in_dim: int, out_dim: int,
                 hidden: Sequence[int] = HIDDEN, out_scale: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        sizes = [in_dim, *hidden, out_dim]
        self.w = nn.ParameterList()
        self.b = nn.ParameterList()
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            scale = (2.0 / a) ** 0.5
            if i == len(sizes) - 2:
                scale *= out_scale
            w = torch.randn((a, b), generator=generator,
                            dtype=torch.float32, device=device) * scale
            self.w.append(nn.Parameter(w))
            self.b.append(nn.Parameter(torch.zeros(b, device=device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.w)
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            x = x @ w + b
            if i < n - 1:
                x = torch.relu(x)
        return x


@torch.no_grad()
def soft_update(target: nn.Module, online: nn.Module, tau: float) -> None:
    """Polyak averaging in place: ``target <- (1 - tau) * target + tau *
    online``."""
    for t, o in zip(target.parameters(), online.parameters()):
        t.copy_((1 - tau) * t + tau * o)
