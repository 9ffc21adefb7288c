"""The served forward's share of the card's peak, in percent: the model's
FLOPs per image from its published layer shapes (2 x the multiply-adds,
``work.flops_per_image``) times ``images_per_s``, over the peak of the
configuration's serving precision (``serve.peak``: bf16 dense, 989
TFLOP/s)."""

from benchmark import peaks, work


def read(run):
    if run.kind != "serve":
        return None
    peak = peaks.PEAKS[run.config["serve"]["peak"]]
    return (100.0 * work.flops_per_image(run.config)
            * run.end_to_end["images_per_s"] / peak)
