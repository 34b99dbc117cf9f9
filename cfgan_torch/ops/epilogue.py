"""The fused counterfactual epilogue (mirrors `cfgan/ops/epilogue.py`).

The CounteRGAN step's elementwise tail, on rows of one sample each:

    masked  = raw * mask
    x_cf    = clip(x + masked, lo, hi)
    l1_sum  = sum_j |masked[i, j]|
    l2_sq   = sum_j masked[i, j]^2
    pen_sum = sum_j |raw[i, j] * (1 - mask[i, j])|

`cf_epilogue_fwd` and `cf_epilogue_bwd` are the wrappers of the
hand-written CUDA kernels (`cfgan_torch/csrc/epilogue.cu`) that replace the
JAX package's Pallas kernels `_fwd_kernel` and `_bwd_kernel`;
`cf_epilogue_fwd_plain` and `cf_epilogue_bwd_plain` are their plain
PyTorch versions, mirroring `_jnp_fwd` and `_jnp_bwd`: the CPU path, and
the yardstick the kernels are held against on the card.  `cf_epilogue` is
the differentiable op, an `autograd.Function` whose backward recomputes
everything from the saved x, raw and mask.
"""
from __future__ import annotations

import torch

from cfgan_torch.ops import _build

_INF = 1e30


def cf_epilogue_fwd_plain(x2, raw2, mask2, lo: float, hi: float):
    """(B, N) rows -> (x_cf (B, N), l1 (B,), l2 (B,), pen (B,))."""
    masked = raw2 * mask2
    cf = torch.clamp(x2 + masked, lo, hi)
    l1 = masked.abs().sum(1)
    l2 = (masked * masked).sum(1)
    pen = (raw2 * (1.0 - mask2)).abs().sum(1)
    return cf, l1, l2, pen


def cf_epilogue_bwd_plain(x2, raw2, mask2, gcf, gl1, gl2, gpen,
                          lo: float, hi: float):
    """(B, N) rows and cotangents gcf (B, N), gl1/gl2/gpen (B,) ->
    (dx (B, N), draw (B, N))."""
    gl1, gl2, gpen = gl1[:, None], gl2[:, None], gpen[:, None]
    masked = raw2 * mask2
    u = x2 + masked
    inr = ((u >= lo) & (u <= hi)).to(x2.dtype)
    du = gcf * inr
    dmasked = du + gl1 * torch.sign(masked) + 2.0 * gl2 * masked
    inv = 1.0 - mask2
    draw = dmasked * mask2 + gpen * torch.sign(raw2 * inv) * inv
    return du, draw


def _float4(n: int, *ptrs: int) -> bool:
    """The choice of `float4_rows`, on N and the tensors' addresses."""
    bits = 0
    for p in ptrs:
        bits |= p
    return n % 4 == 0 and bits % 16 == 0


def float4_rows(*rows: torch.Tensor) -> bool:
    """Whether the kernels may move these (B, N) rows 16 bytes at a time:
    N % 4 == 0 and every tensor's first element 16-byte aligned.  Where
    not (N = 17, or a view that starts at an odd `storage_offset`), the
    wrappers launch the same kernels' 4-byte variant."""
    return _float4(rows[0].shape[1], *(t.data_ptr() for t in rows))


def _check(rows, cols) -> None:
    """Every (B, N) row tensor and (B,) column the kernels take: float32,
    contiguous, on one CUDA device, 32-bit sizes."""
    b, n = rows[0].shape
    if max(b, n) >= 2 ** 31:
        raise ValueError(f"cf_epilogue: rows {b} x {n} exceed the kernels' "
                         "32-bit sizes")
    device = rows[0].device
    for t in (*rows, *cols):
        if t.device != device or device.type != "cuda":
            raise ValueError(f"cf_epilogue: tensors on {t.device} and "
                             f"{device}; all must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"cf_epilogue: {t.dtype}; the kernels take "
                            "float32 only")
        if not t.is_contiguous():
            raise ValueError("cf_epilogue: inputs must be contiguous")
    if any(t.shape != (b, n) for t in rows) or any(t.shape != (b,)
                                                   for t in cols):
        raise ValueError("cf_epilogue: rows must be (B, N) and columns (B,)")


def _launched(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"cf_epilogue {what} kernel launch failed: "
                           f"cudaError {err}")


def cf_epilogue_fwd(x2, raw2, mask2, lo: float, hi: float):
    """Forward on (B, N) rows.  A CPU tensor takes the plain version.  A
    CUDA tensor launches the hand-written kernel (float32 only), 16 bytes
    at a time where `float4_rows` allows it and 4 otherwise, or raises:
    there is no fallback.  Each launch adds one to
    `cf_epilogue_fwd.launches` and sets `cf_epilogue_fwd.last_float4` to
    the variant it launched (True: 16-byte)."""
    if x2.is_cpu:
        return cf_epilogue_fwd_plain(x2, raw2, mask2, lo, hi)
    lib = _build.load_library().lib  # raises where it cannot be built
    _check((x2, raw2, mask2), ())
    b, n = x2.shape
    cf = torch.empty_like(x2)
    sums = x2.new_empty((3, b))  # l1, l2, pen
    if b == 0 or n == 0:
        return cf, *sums.zero_().unbind(0)
    ptrs = x2.data_ptr(), raw2.data_ptr(), mask2.data_ptr(), cf.data_ptr()
    vec = _float4(n, *ptrs)
    _launched(lib.cfgan_epilogue_fwd_f32(
        *ptrs, sums.data_ptr(), b, n, lo, hi, vec,
        torch._C._cuda_getCurrentRawStream(x2.get_device())), "forward")
    cf_epilogue_fwd.launches += 1
    cf_epilogue_fwd.last_float4 = vec
    return cf, *sums.unbind(0)


cf_epilogue_fwd.launches = 0
cf_epilogue_fwd.last_float4 = None


def cf_epilogue_bwd(x2, raw2, mask2, gcf, gl1, gl2, gpen,
                    lo: float, hi: float):
    """Backward on (B, N) rows: (dx, draw).  Dispatch, variants, checks and
    the launch count (`cf_epilogue_bwd.launches`, `.last_float4`) as for
    `cf_epilogue_fwd`."""
    if x2.is_cpu:
        return cf_epilogue_bwd_plain(x2, raw2, mask2, gcf, gl1, gl2, gpen,
                                     lo, hi)
    lib = _build.load_library().lib
    _check((x2, raw2, mask2, gcf), (gl1, gl2, gpen))
    b, n = x2.shape
    dx, draw = torch.empty_like(x2), torch.empty_like(x2)
    if b == 0 or n == 0:
        return dx, draw
    ptrs = (x2.data_ptr(), raw2.data_ptr(), mask2.data_ptr(), gcf.data_ptr(),
            dx.data_ptr(), draw.data_ptr())
    vec = _float4(n, *ptrs)
    _launched(lib.cfgan_epilogue_bwd_f32(
        *ptrs[:4], gl1.data_ptr(), gl2.data_ptr(), gpen.data_ptr(), *ptrs[4:],
        b, n, lo, hi, vec,
        torch._C._cuda_getCurrentRawStream(x2.get_device())), "backward")
    cf_epilogue_bwd.launches += 1
    cf_epilogue_bwd.last_float4 = vec
    return dx, draw


cf_epilogue_bwd.launches = 0
cf_epilogue_bwd.last_float4 = None


def _rows(t: torch.Tensor, b: int) -> torch.Tensor:
    return t.reshape(b, -1).contiguous()


class _CFEpilogue(torch.autograd.Function):
    """Saves x, raw and mask only; the mask gets no gradient (masks are
    sampled, never learned)."""

    @staticmethod
    def forward(ctx, x, raw, mask, lo, hi):
        b = x.shape[0]
        cf, l1, l2, pen = cf_epilogue_fwd(_rows(x, b), _rows(raw, b),
                                          _rows(mask, b), lo, hi)
        ctx.save_for_backward(x, raw, mask)
        ctx.lo, ctx.hi = lo, hi
        return cf.reshape(x.shape), l1, l2, pen

    @staticmethod
    def backward(ctx, gcf, gl1, gl2, gpen):
        x, raw, mask = ctx.saved_tensors
        b = x.shape[0]
        dx, draw = cf_epilogue_bwd(
            _rows(x, b), _rows(raw, b), _rows(mask, b), _rows(gcf, b),
            gl1.contiguous(), gl2.contiguous(), gpen.contiguous(),
            ctx.lo, ctx.hi)
        return (dx.reshape(x.shape) if ctx.needs_input_grad[0] else None,
                draw.reshape(raw.shape), None, None, None)


def cf_epilogue(x: torch.Tensor, raw: torch.Tensor, mask: torch.Tensor,
                lo: float = -_INF, hi: float = _INF):
    """Returns (x_cf, l1_sum, l2_sumsq, pen_sum); the sums are (B,) vectors.

    `x`/`raw`/`mask` may be any (B, ...) shape; the sums run over all
    non-batch axes.  Differentiable in `x` and `raw`; `mask` gets no
    gradient.  The default bounds are the no-clamp mode."""
    return _CFEpilogue.apply(x, raw, mask, float(lo), float(hi))


def epilogue_terms(l1_sum, l2_sumsq, pen_sum, n_features: int,
                   reg_reduction: str = "per_sample_norm"):
    """The per-sample sums reduced to the scalar CounteRGAN loss terms
    (l1, l2, pen), as `cfgan_torch.losses.countergan`'s `proximity_l1/l2`
    and `mask_penalty` compute them."""
    l1 = l1_sum.mean()
    if reg_reduction == "mean_abs":
        l1 = l1 / n_features
    l2 = torch.sqrt(l2_sumsq + 1e-24).mean()
    pen = pen_sum.mean() / n_features
    return l1, l2, pen
