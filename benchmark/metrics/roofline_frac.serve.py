"""The served forward's share of its roofline, in percent: the least time
of one forward of the cell's batch (``work.least_seconds``: over the
published layers, the larger of FLOPs over the bf16 peak and bytes over
the HBM bandwidth) over the device's busy time a forward in the traced
stretch (the union of its device operations, copies included)."""

from benchmark import peaks, work


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    peak = peaks.PEAKS[run.config["serve"]["peak"]]
    busy = run.trace["busy_s"] / run.trace["calls"]
    return 100.0 * work.least_seconds(run.config, run.batch, peak) / busy
