"""The whole step's share of the card's peak: the model's FLOPs a step
(convolutions and matrix products, forward and backward, counted on the
frozen reference at the cell's shapes) over the unprofiled window's step
time, against the peak of the cell's compute dtype (``peaks.json``)."""


def read(t):
    if not t.flops_per_step or not t.device_ops:
        return None
    peak = t.peaks["flops"][t.cell.traffic["compute_dtype"]]
    return 100.0 * t.flops_per_step / t.step_s / peak
