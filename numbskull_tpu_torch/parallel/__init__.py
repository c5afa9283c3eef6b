"""Multi-device and multi-process execution: ``mesh`` (the (chains,
graph) mesh), ``sharded`` (``ShardedGibbsEngine`` over a mesh),
``partition`` (choosing a variable partition), ``bsp`` (bulk-synchronous
partitioned Gibbs, ``BSPEngine`` and ``BSPItemGridInference``) and
``multihost`` (the ``torch.distributed`` process group, ``global_mesh``,
and the group that ``ops.itemgrid_mc.MultiChipItemGridEngine`` shards a
graph over)."""

from numbskull_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from numbskull_tpu_torch.parallel.partition import (  # noqa: F401
    balanced_partition, choose_partition, connected_components, edge_cut,
    make_part_plans, partition_cost,
)


def __getattr__(name):
    # lazy, as in the JAX package: the engines import the ops modules
    if name in ("ShardedGibbsEngine", "ShardedState"):
        from numbskull_tpu_torch.parallel import sharded
        return getattr(sharded, name)
    if name in ("BSPEngine", "BSPItemGridInference"):
        from numbskull_tpu_torch.parallel import bsp
        return getattr(bsp, name)
    raise AttributeError(name)
