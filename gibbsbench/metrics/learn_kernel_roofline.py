"""learn_kernel_roofline: the least time of one learning epoch, counted
from the graph (``costmodel.epoch_cost``), as a share of the device time
per epoch in the traced slice: every device interval, whatever its
kernel (learn_cat_kernel<8> in ehr.learn)."""


def read(run: dict):
    t = run.get("trace")
    if run.get("phase") != "learning" or not t or not t["busy_s"]:
        return None
    return 100.0 * run["cost"]["seconds"] * run["trace_epochs"] / \
        t["busy_s"]
