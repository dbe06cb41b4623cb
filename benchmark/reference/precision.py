"""Rounding to a compute precision, for the reference and its control.

The reference runs in float32 (TF32 off). Its control runs the same
arithmetic with every value that the configuration computes in bf16
rounded to a lower precision instead. Rounding passes the gradient
through unchanged, so the backward differs only through the rounded
forward values.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # the largest finite float8_e4m3fn value

PRECISIONS = ("float32", "bfloat16", "float8_e4m3fn")


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled float8 e4m3: the tensor's largest magnitude maps to
    the format's largest value, as an fp8 kernel scales its operands."""
    amax = x.detach().abs().amax().float()
    scale = FP8_MAX / torch.clamp(amax, min=1e-30)
    return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale


_ROUND = {
    "bfloat16": lambda x: x.to(torch.bfloat16).float(),
    "float8_e4m3fn": _fp8,
}


class _RoundThrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):  # noqa: ARG004 - autograd API
        return fn(x)

    @staticmethod
    def backward(ctx, grad):  # noqa: ARG004 - autograd API
        return grad, None


def rounder(precision: str):
    """x -> x rounded to `precision` (identity for float32)."""
    if precision not in PRECISIONS:
        msg = f"unknown precision {precision!r}"
        raise ValueError(msg)
    if precision == "float32":
        return lambda x: x
    fn = _ROUND[precision]
    return lambda x: _RoundThrough.apply(x, fn)


def set_exact_float32() -> None:
    """Matrix products in true float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
