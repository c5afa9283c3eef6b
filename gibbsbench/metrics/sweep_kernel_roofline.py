"""sweep_kernel_roofline: the least time of one inference epoch, counted
from the graph (``costmodel.epoch_cost``), as a share of the device time
per epoch in the traced slice: every device interval, whatever its
kernel (sweep_cat_kernel<8> in ehr.infer)."""


def read(run: dict):
    t = run.get("trace")
    if run.get("phase") != "inference" or not t or not t["busy_s"]:
        return None
    return 100.0 * run["cost"]["seconds"] * run["trace_epochs"] / \
        t["busy_s"]
