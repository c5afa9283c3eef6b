"""Partitioned and multi-process execution: ``partition`` (choosing a
variable partition), ``bsp`` (bulk-synchronous partitioned Gibbs,
``BSPEngine`` and ``BSPItemGridInference``) and ``multihost`` (the
``torch.distributed`` process group that
``ops.itemgrid_mc.MultiChipItemGridEngine`` shards a graph over)."""
