"""The configurations' optimizers, as optax defines them: SGD and Adam
(b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias correction at
count + 1), the learning rate lr(step) = base_lr * decay ** (step / nb + 1)
read at the step count before the update, all in float32."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def learning_rate(base_lr: float, decay: float, nb_iterations: int, step: int) -> np.float32:
    f32 = np.float32
    return f32(base_lr) * np.power(f32(decay), f32(step) / f32(nb_iterations) + f32(1.0))


class Optimizer:
    """``update(params, grads)`` in place, one step; ``params`` and
    ``grads`` are dicts of tensors of one shape each."""

    def __init__(self, name: str, base_lr: float, decay: float, nb_iterations: int):
        if name not in ("sgd", "adam"):
            raise ValueError(f"unknown optimizer {name!r}")
        self.name, self.base_lr, self.decay, self.nb = name, base_lr, decay, nb_iterations
        self.count = 0
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        lr = float(learning_rate(self.base_lr, self.decay, self.nb, self.count))
        for k, g in grads.items():
            if self.name == "sgd":
                params[k].sub_(lr * g)
                continue
            mu = 0.1 * g + 0.9 * self.mu.get(k, torch.zeros_like(g))
            nu = 0.001 * g * g + 0.999 * self.nu.get(k, torch.zeros_like(g))
            bc1 = 1.0 - 0.9 ** (self.count + 1)
            bc2 = 1.0 - 0.999 ** (self.count + 1)
            params[k].sub_(lr * (mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8))
            self.mu[k], self.nu[k] = mu, nu
        self.count += 1
