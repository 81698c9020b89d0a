"""TF32 arithmetic on the CPU, shared by the tests that emulate the port's
3xTF32 kernels (K3's f32 forward and backward, K4 and its backward)."""

import torch


def tf32_cut(t):
    """float32 ``t`` with its 13 low mantissa bits cleared: TF32 by truncation."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_mm(a, b, split):
    """``a @ b`` as the tensor-core products compute it: each operand cut to
    TF32 (hi), and with ``split`` the rest of it (lo = v - hi, which the
    tensor core cuts to TF32 as well) in two more products, the small terms
    a_lo b_hi + a_hi b_lo summed apart before they join a_hi b_hi; f32 sums."""
    ah, bh = tf32_cut(a), tf32_cut(b)
    if not split:
        return ah @ bh
    return ah @ bh + (tf32_cut(a - ah) @ bh + ah @ tf32_cut(b - bh))
