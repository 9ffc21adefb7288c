"""The QAT step's share of the card's peak, in percent: 3 x the forward's
FLOPs per image (forward, and the backward's two products) times
``train_images_per_s``, over the peak of the configuration's training
precision (``train.peak``: float32, 67 TFLOP/s)."""

from benchmark import peaks, work


def read(run):
    if run.kind != "train":
        return None
    peak = peaks.PEAKS[run.config["train"]["peak"]]
    return (100.0 * 3.0 * work.flops_per_image(run.config)
            * run.end_to_end["train_images_per_s"] / peak)
