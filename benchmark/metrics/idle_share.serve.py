"""The device's idle share of the traced serving stretch, in percent:
1 - (union of device operations) / (the stretch's length)."""


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
