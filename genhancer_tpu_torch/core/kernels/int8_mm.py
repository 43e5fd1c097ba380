"""The exact int8 GEMM of every int8 product: ``torch._int_mm`` under its
CUDA shape rules.  Not a kernel of this package — a library call that the
int8 linears (``core.quant``) and K8's plain version share."""

from __future__ import annotations

import torch


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product ``a @ b`` through ``torch._int_mm``.

    On CUDA ``_int_mm`` takes M > 16, K and N multiples of 8, and ``b``
    column-major (cuBLASLt's int8 GEMM refuses a row-major one): M is padded
    with zero rows, K and N with zero columns, all exact, and ``b`` is laid
    out column-major; a product it still refuses raises — there is no float
    fallback, which would not be exact."""
    if a.device.type == "cpu":
        return torch._int_mm(a.contiguous(), b.contiguous())
    m, k = a.shape
    n = b.shape[1]
    if k == 0:      # no rows to contract (a rank holding none): the zero sum
        return torch.zeros((m, n), dtype=torch.int32, device=a.device)
    pm, pk, pn = max(17 - m, 0), -k % 8, -n % 8
    if pm or pk:
        a = torch.nn.functional.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = torch.nn.functional.pad(b, (0, pn, 0, pk))
    if not (a.is_contiguous() or a.t().is_contiguous()):
        a = a.contiguous()
    if not b.t().is_contiguous():
        b = b.t().contiguous().t()
    out = torch._int_mm(a, b)
    return out[:m, :n] if (pm or pn) else out
