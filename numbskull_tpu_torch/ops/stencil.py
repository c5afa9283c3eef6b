"""Checkerboard Gibbs engine for Ising lattices (no gathers).

Port of ``numbskull_tpu/ops/stencil.py``: ``GridState`` and
``GridGibbsEngine`` for an n x m grid with EQUAL pairwise coupling and an
optional per-site ISTRUE bias, with the semantics of the general engine
on the same graph:

    pot(k) = w_eq * sum_nbrs eval_EQUAL(k, x_nbr) + w_bias * eval_ISTRUE(k)
    P(x=1) = sigmoid(pot(1) - pot(0)) = sigmoid(2 w_eq (2 s - deg) + 2 w_bias)

Every run goes through ``ops/stencil_kernel.grid_gibbs``: the CUDA
kernel for a state on the card, its plain PyTorch version for a state
on the CPU. The draws come from the counter hash with the salts written
down in ``ops/stencil_kernel``, in place of ``jax.random``, so the two
packages agree in distribution, not bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from numbskull_tpu_torch.ops.stencil_kernel import grid_gibbs, initial_lattice


@dataclasses.dataclass
class GridState:
    x: torch.Tensor       # (n, m) int32 spins in {0, 1}
    count: torch.Tensor   # (n, m) int32 tally of value == 1


class GridGibbsEngine:
    """Checkerboard Gibbs on an n x m grid with EQUAL couplings, its
    state on ``device``."""

    def __init__(self, n: int, m: int, weight: float,
                 bias_weight: float = 0.0, device="cuda"):
        self.n, self.m = int(n), int(m)
        self.weight = float(weight)
        self.bias_weight = float(bias_weight)
        self.device = torch.device(device)

    def init_state(self, seed: int = 0) -> GridState:
        x = initial_lattice(seed, self.n, self.m, self.device)
        return GridState(x=x, count=torch.zeros_like(x))

    def inference(self, state: GridState, seed: int, epochs: int,
                  burn: int = 0) -> GridState:
        """``burn`` untallied and ``epochs`` tallied sweeps from
        ``state``; the new state's count adds this run's tallies to
        ``state.count``."""
        x, count = grid_gibbs(state.x, seed, burn, epochs, n=self.n,
                              m=self.m, weight=self.weight,
                              bias=self.bias_weight)
        return GridState(x=x, count=state.count + count)

    def run(self, seed: int, burn: int, epochs: int, x0=None):
        """``(x, count)`` after ``burn`` + ``epochs`` sweeps from ``x0``
        (drawn from ``seed`` when None), as PallasGridGibbsEngine.run:
        ``count`` tallies this run's epochs only. No cell cap."""
        if x0 is None:
            x0 = initial_lattice(seed, self.n, self.m, self.device)
        x0 = torch.as_tensor(x0, dtype=torch.int32, device=self.device)
        return grid_gibbs(x0.contiguous(), seed, burn, epochs, n=self.n,
                          m=self.m, weight=self.weight, bias=self.bias_weight)

    def marginals(self, state: GridState, epochs: int) -> np.ndarray:
        return state.count.cpu().numpy().astype(np.float64) / max(epochs, 1)
