"""device_idle.infer: the share of the traced slice's wall time in which no
device operation ran, 1 - (the union of device intervals) / (wall time),
the method of ``chip_smoke.device_busy``."""


def read(run: dict):
    t = run.get("trace")
    if run.get("phase") != "inference" or not t or t["busy_s"] is None:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
