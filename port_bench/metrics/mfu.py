"""The whole step's share of the card's peak: the model FLOPs of the
traced span's units (``counts.model_flops``: the forward's products and
means, in training also the gradients) over the span's length at the
TF32 tensor-core rate, in percent."""

from port_bench import counts


def read(view):
    flops = view.info["unit_flops"] * view.units
    if view.window_s <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (view.window_s * counts.TF32_FLOPS_PER_S)
