"""Categorical sampling from unnormalized log-potentials.

Port of ``numbskull_tpu/ops/sample.py``: the vectorized form of the
reference's per-variable inverse-CDF draw (reference:
numbskull/inference.py:36-52): Z[k] = exp(potential_k), cumsum, u * Z[last],
first index with cumsum >= u; max-subtracted for float32 stability and
computed for a whole color block at once. The uniforms come from a
``torch.Generator`` (Philox on the card), not ``jax.random``: the draws
agree with the JAX package's in distribution, not bit for bit.
"""

from __future__ import annotations

import torch


def make_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    return g


def draw(pot: torch.Tensor, card: torch.Tensor,
         generator: torch.Generator) -> torch.Tensor:
    """Sample one value per row from softmax(potential) over k < card.

    Args:
      pot:  (R, K) float32 unnormalized log-potentials.
      card: (R,) integer cardinalities (rows use only k < card).
      generator: the source of the (R,) uniforms, on pot's device.

    Returns:
      (R,) int64 sampled values in [0, card).
    """
    R, K = pot.shape
    ks = torch.arange(K, device=pot.device)
    mask = ks[None, :] < card[:, None]
    logits = torch.where(mask, pot, float("-inf"))
    m = logits.amax(dim=1, keepdim=True)
    z = torch.where(mask, torch.exp(logits - m), 0.0)
    csum = torch.cumsum(z, dim=1)
    u = torch.rand((R, 1), generator=generator, dtype=pot.dtype,
                   device=pot.device) * csum[:, -1:]
    val = (csum < u).sum(dim=1)
    return torch.minimum(val, card.to(val.dtype) - 1)
