"""learn.launches_per_epoch: launches of the host loop per epoch, the
change in ``ops/itemgrid.LEARN_LAUNCHES`` (learn step and sum launches)
over the traced slice."""


def read(run: dict):
    if run.get("phase") != "learning" or not run.get("trace_epochs"):
        return None
    return run["launches"]["LEARN_LAUNCHES"] / run["trace_epochs"]
