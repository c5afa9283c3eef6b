"""spouse.sum_share: the share of the traced learning slice's device time
spent in the weight-sum kernel (device operations whose name holds
``learn_sum_kernel``), in percent; None where the slice names no such
operation among its largest."""


def read(run: dict):
    t = run.get("trace")
    if run.get("phase") != "learning" or not t or not t["busy_s"]:
        return None
    s = sum(sec for name, sec in t["device_ops"]
            if "learn_sum_kernel" in name)
    return 100.0 * s / t["busy_s"] if s else None
