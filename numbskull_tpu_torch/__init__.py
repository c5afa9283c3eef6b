"""numbskull_tpu_torch: the PyTorch and CUDA port of numbskull_tpu.

Gibbs inference over DeepDive factor graphs on an NVIDIA GPU. The JAX
package ``numbskull_tpu`` beside it is the reference this port is held
against; the port imports ``torch`` and never ``jax``.

Modules copied from the JAX package (pure numpy, import paths aside):
``types``, ``timer``, ``plancache``, ``dataloading``, ``compile``,
``dbsource`` (``bsp_from_db`` takes ``device=``), ``parallel.partition``
and ``models`` (coin, ising, lf, voting). Rewritten on torch tensors:
``observability`` (the Metrics registry and the profiler hooks),
``checkpoint`` (state and base seed in one ``.npz``), ``resilience``
(checkpointed chunks with recovery), ``ops.factor_semantics``,
``ops.factor_eval``, ``ops.gibbs`` (state, plain potentials and the
tensor-op engine), ``ops.itemgrid`` (the fused sweep: CUDA kernel in
``csrc/itemgrid_sweep.cu``, its plain version, and the engine),
``convert`` and ``numbskull`` (the CLI). Graph-sharded runs:
``ops.itemgrid_mc`` (``MultiChipItemGridEngine``, shards in one process
or one per process of a ``torch.distributed`` group, the exchange kernel
in ``csrc/itemgrid_exchange.cu``) and ``parallel.multihost`` (joining
the group); the (chains, graph) mesh: ``parallel.mesh``,
``parallel.sharded`` (``ShardedGibbsEngine``, in one process or over a
group, ``multihost.global_mesh``); partitioned runs: ``parallel.bsp``.
``models.replicate`` is copied too.
"""

__version__ = "0.1.0"

from numbskull_tpu_torch import dataloading  # noqa: F401
from numbskull_tpu_torch import dbsource  # noqa: F401
from numbskull_tpu_torch import observability  # noqa: F401
from numbskull_tpu_torch import resilience  # noqa: F401
from numbskull_tpu_torch.checkpoint import (  # noqa: F401
    load_checkpoint, save_checkpoint,
)
from numbskull_tpu_torch import types  # noqa: F401
from numbskull_tpu_torch.compile import compile_graph, CompiledGraph  # noqa: F401
from numbskull_tpu_torch.numbskull import NumbSkull, load, main  # noqa: F401
from numbskull_tpu_torch.ops.gibbs import (  # noqa: F401
    GibbsEngine, LearnParams, SamplerState,
)
from numbskull_tpu_torch.ops.itemgrid import ItemGridEngine  # noqa: F401
from numbskull_tpu_torch.types import FACTORS  # noqa: F401
