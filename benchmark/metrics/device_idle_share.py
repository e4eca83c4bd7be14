"""Device: 1 minus the union of kernel, memcpy and memset intervals over the traced window."""


def read(run):
    if run.window_s <= 0 or not run.ops:
        return None
    return 1.0 - run.busy_s() / run.window_s
