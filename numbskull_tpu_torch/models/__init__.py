"""Factor-graph model families (host-side generators, numpy only).

Copies of ``numbskull_tpu/models``' coin, ising, lf and voting
generators. Each returns the ``(weight, variable, factor, fmap,
domain_mask, edges)`` tuple accepted by ``NumbSkull.loadFactorGraph``.
"""

from numbskull_tpu_torch.models.ising import (  # noqa: F401
    ising_color_hint, ising_grid, potts_grid,
)
from numbskull_tpu_torch.models.coin import coin_model, coin_exact_marginal  # noqa: F401
from numbskull_tpu_torch.models.lf import lf_model, lf_exact_cdf  # noqa: F401
from numbskull_tpu_torch.models.voting import (  # noqa: F401
    voting_grouped, voting_model,
)
