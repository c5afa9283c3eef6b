"""sweep.launches_per_epoch: launches of the host loop per epoch, the
change in ``ops/itemgrid.KERNEL_LAUNCHES`` (sweep launches) over the
traced slice."""


def read(run: dict):
    if run.get("phase") != "inference" or not run.get("trace_epochs"):
        return None
    return run["launches"]["KERNEL_LAUNCHES"] / run["trace_epochs"]
