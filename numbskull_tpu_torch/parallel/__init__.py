"""Running the port over several processes: the ``torch.distributed``
process group that ``ops.itemgrid_mc.MultiChipItemGridEngine`` shards a
graph over."""
