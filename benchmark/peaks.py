"""Published peaks of the card the cells run on: one NVIDIA H100 SXM (80 GB
HBM3), dense rates without sparsity, at its 700 W limit (NVIDIA's data
sheet).  Rooflines and the model FLOP utilisation are taken against the
bfloat16 tensor-core rate, the highest that a correct implementation of
these configurations' math could use, so none can read over 100%."""

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take for the work: operations at the
    bfloat16 peak or bytes at the HBM rate, whichever is longer."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
