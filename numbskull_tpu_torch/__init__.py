"""numbskull_tpu_torch: the PyTorch and CUDA port of numbskull_tpu.

Gibbs inference over DeepDive factor graphs on an NVIDIA GPU. The JAX
package ``numbskull_tpu`` beside it is the reference this port is held
against; the port imports ``torch`` and never ``jax``.

Modules copied from the JAX package (pure numpy, import paths aside):
``types``, ``timer``, ``plancache``, ``dataloading``, ``compile`` and
``models`` (coin, ising, lf, voting). Rewritten on torch tensors:
``observability`` (the Metrics registry), ``ops.factor_semantics``,
``ops.factor_eval``, ``ops.gibbs`` (state and plain potentials),
``ops.itemgrid`` (the fused sweep: CUDA kernel in
``csrc/itemgrid_sweep.cu``, its plain version, and the engine),
``convert`` and ``numbskull`` (the CLI inference path). Graph-sharded
runs: ``ops.itemgrid_mc`` (``MultiChipItemGridEngine``, shards in one
process or one per process of a ``torch.distributed`` group, the
exchange kernel in ``csrc/itemgrid_exchange.cu``) and
``parallel.multihost`` (joining the group).
"""

__version__ = "0.1.0"

from numbskull_tpu_torch import dataloading  # noqa: F401
from numbskull_tpu_torch import observability  # noqa: F401
from numbskull_tpu_torch import types  # noqa: F401
from numbskull_tpu_torch.compile import compile_graph, CompiledGraph  # noqa: F401
from numbskull_tpu_torch.numbskull import NumbSkull, load, main  # noqa: F401
from numbskull_tpu_torch.ops.gibbs import SamplerState  # noqa: F401
from numbskull_tpu_torch.ops.itemgrid import ItemGridEngine  # noqa: F401
from numbskull_tpu_torch.types import FACTORS  # noqa: F401
