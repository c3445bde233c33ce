"""NVIDIA's published peaks of one H100 SXM (data sheet, dense, no
sparsity), at its full 700 W: a share of them is stated with the card's
power limit beside it."""
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12        # float32 outside the tensor cores
BF16_FLOP_S = 989e12       # bf16 / fp16 tensor cores


def bound_s(work: dict) -> float:
    """The least time the card could take for `work` (ops, ops_bf16,
    bytes): the larger of its bytes over the memory rate and its ops over
    the peak of the precision they are specified in."""
    t_ops = work.get("ops", 0) / FP32_FLOP_S \
        + work.get("ops_bf16", 0) / BF16_FLOP_S
    return max(work.get("bytes", 0) / HBM_BYTES_S, t_ops)


def ops_s(work: dict) -> float:
    """The ops time alone (the mfu numerator)."""
    return work.get("ops", 0) / FP32_FLOP_S \
        + work.get("ops_bf16", 0) / BF16_FLOP_S
