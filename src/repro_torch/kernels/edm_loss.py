"""Fused EDM denoising loss (port of ``repro.kernels.edm_loss``; CUDA
source ``csrc/edm_loss.cu``), paper Eq. 2/6 in F-space:

  partials[b, tile] = sum over the tile's rows of ||F − (y − c_skip z)/c_out||²
  loss = sum(partials) / (B · S · d)

The target is formed in registers on both passes and never stored. Tiles are
``block_rows`` rows of one example (256, or S if shorter), as in JAX, so the
partials have the Pallas kernel's (B, n_tiles) shape.

Two wrappers, one per kernel, each counting its launches in ``.launches``:
``edm_loss_fwd`` -> partials and ``edm_loss_bwd`` -> (df, dz, dy). On CUDA
tensors they launch the kernel or raise (fp32 streams only: the training
path hands them fp32); on CPU tensors they run the plain versions
(``edm_loss_partials_ref``, ``edm_loss_bwd_ref``). ``edm_loss_partials``
ties them together in a ``torch.autograd.Function`` over (f, z, y): σ is
sampled noise-schedule data and gets no gradient.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

BLOCK_ROWS = 256
SUB_ROWS = 16          # rows per CUDA block of the forward (sub-tiles)
_FN = {}


def _coeffs(sigma, sigma_data: float):
    """c_skip, c_out (B,) fp32 per EDM preconditioning, in the form of
    ``repro.kernels.edm_loss._coeffs``."""
    sf = sigma.float()
    s2 = sf ** 2
    d2 = sigma_data ** 2
    c_skip = d2 / (s2 + d2)
    c_out = sf * sigma_data * torch.rsqrt(s2 + d2)
    return c_skip, c_out


# ---------------------------------------------------------------------------
# Plain versions (the JAX kernels' formulas, fp32 math)
# ---------------------------------------------------------------------------

def _target(z, y, c_skip, c_out):
    return (y.float() - c_skip[:, None, None] * z.float()) \
        / c_out[:, None, None]


def edm_loss_partials_ref(f, z, y, c_skip, c_out, block_rows: int):
    """(B, n_tiles) fp32: per-tile sums of (f − t)², rows past S zero."""
    B, S, d = f.shape
    err = (f.float() - _target(z, y, c_skip, c_out)).square()
    nt = -(-S // block_rows)
    err = F.pad(err, (0, 0, 0, nt * block_rows - S))
    return err.reshape(B, nt, block_rows * d).sum(-1)


def edm_loss_bwd_ref(f, z, y, c_skip, c_out, g, block_rows: int):
    """(df, dz, dy) of ``_loss_bwd_kernel``: df = 2 (f − t) g[b, tile],
    dz = (c_skip / c_out) df, dy = −df / c_out; each in its input's dtype."""
    S = f.shape[1]
    gt = g.float().repeat_interleave(block_rows, dim=1)[:, :S, None]
    cs, co = c_skip[:, None, None], c_out[:, None, None]
    df = 2.0 * (f.float() - _target(z, y, c_skip, c_out)) * gt
    dz = df * (cs / co)
    dy = -df / co
    return df.to(f.dtype), dz.to(z.dtype), dy.to(y.dtype)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int


def _kernel(sym: str, argtypes):
    if sym not in _FN:
        fn = getattr(_build.load("edm_loss"), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FN[sym] = fn
    return _FN[sym]


def _check(name, streams, coeffs):
    """Raise on what the kernels do not take; returns (B, S, d)."""
    f = streams[0]
    if any(t.device.type != "cuda" or t.device != f.device
           for t in streams + coeffs):
        raise ValueError(f"{name}: every tensor must lie on one CUDA device")
    if any(t.dtype != torch.float32 for t in streams + coeffs):
        raise TypeError(f"{name}: the kernels take fp32 f, z, y (and fp32 "
                        f"coefficients), got "
                        f"{[t.dtype for t in streams + coeffs]}")
    if f.ndim != 3 or any(t.shape != f.shape for t in streams):
        raise ValueError(f"{name}: f, z, y must be (B, S, d) alike, got "
                         f"{[tuple(t.shape) for t in streams]}")
    B, S, d = f.shape
    if any(tuple(c.shape) != (B,) or not c.is_contiguous() for c in coeffs):
        raise ValueError(f"{name}: c_skip and c_out must be contiguous (B,) "
                         f"= ({B},)")
    if d % 4:
        raise NotImplementedError(f"{name}: d must be a multiple of 4")
    if S == 0 or B == 0:
        raise ValueError(f"{name}: empty batch or sequence")
    if not all(t.is_contiguous() for t in streams) \
            or any(t.data_ptr() % 16 for t in streams):
        raise ValueError(f"{name}: f, z, y must be contiguous and 16-byte "
                         "aligned")
    return B, S, d


def edm_loss_fwd(f, z, y, c_skip, c_out, block_rows: int = BLOCK_ROWS):
    """(B, ceil(S / block_rows)) fp32 partial sums of the squared error."""
    if f.device.type == "cpu":
        return edm_loss_partials_ref(f, z, y, c_skip, c_out, block_rows)
    B, S, d = _check("edm_loss_fwd", (f, z, y), (c_skip, c_out))
    n_sub = -(-block_rows // SUB_ROWS)
    part = torch.empty((B, -(-S // block_rows), n_sub), dtype=torch.float32,
                       device=f.device)
    fn = _kernel("rt_edm_loss_fwd", [_P] * 6 + [_I] * 5 + [_P])
    with torch.cuda.device(f.device):
        rc = fn(f.data_ptr(), z.data_ptr(), y.data_ptr(), c_skip.data_ptr(),
                c_out.data_ptr(), part.data_ptr(), B, S, d, block_rows,
                SUB_ROWS, torch.cuda.current_stream(f.device).cuda_stream)
    _build.check(rc, "edm_loss_fwd")
    edm_loss_fwd.launches += 1
    return part.sum(-1)


def edm_loss_bwd(f, z, y, c_skip, c_out, g, block_rows: int = BLOCK_ROWS):
    """(df, dz, dy) from g, the (B, n_tiles) cotangent of the partials."""
    if f.device.type == "cpu":
        return edm_loss_bwd_ref(f, z, y, c_skip, c_out, g, block_rows)
    B, S, d = _check("edm_loss_bwd", (f, z, y), (c_skip, c_out))
    g = g.float().contiguous()
    if tuple(g.shape) != (B, -(-S // block_rows)) or g.device != f.device:
        raise ValueError(f"edm_loss_bwd: g must be (B, n_tiles) = "
                         f"{(B, -(-S // block_rows))} on f's device, got "
                         f"{tuple(g.shape)}")
    df, dz, dy = (torch.empty_like(t) for t in (f, z, y))
    fn = _kernel("rt_edm_loss_bwd", [_P] * 9 + [_I] * 4 + [_P])
    with torch.cuda.device(f.device):
        rc = fn(f.data_ptr(), z.data_ptr(), y.data_ptr(), c_skip.data_ptr(),
                c_out.data_ptr(), g.data_ptr(), df.data_ptr(), dz.data_ptr(),
                dy.data_ptr(), B, S, d, block_rows,
                torch.cuda.current_stream(f.device).cuda_stream)
    _build.check(rc, "edm_loss_bwd")
    edm_loss_bwd.launches += 1
    return df, dz, dy


edm_loss_fwd.launches = 0
edm_loss_bwd.launches = 0


# ---------------------------------------------------------------------------
# Differentiable entry points
# ---------------------------------------------------------------------------

class _Partials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, z, y, sigma, sigma_data, block_rows):
        c_skip, c_out = _coeffs(sigma, sigma_data)
        ctx.block_rows = block_rows
        ctx.save_for_backward(f, z, y, c_skip, c_out)
        return edm_loss_fwd(f, z, y, c_skip, c_out, block_rows)

    @staticmethod
    def backward(ctx, g):
        f, z, y, c_skip, c_out = ctx.saved_tensors
        df, dz, dy = edm_loss_bwd(f, z, y, c_skip, c_out, g, ctx.block_rows)
        # σ parameterizes the sampled noise level: never differentiated
        return df, dz, dy, None, None, None


def edm_loss_partials(f, z, y, sigma, sigma_data: float,
                      block_rows: int = BLOCK_ROWS):
    """f/z/y: (B, S, d); sigma: (B,). Returns the (B, n_tiles) partial
    sums; loss = sum(partials) / (B*S*d). Differentiable w.r.t. f, z, y."""
    block_rows = min(block_rows, f.shape[1])
    return _Partials.apply(f.contiguous(), z.contiguous(), y.contiguous(),
                           sigma, sigma_data, block_rows)


def edm_loss(f, z, y, sigma, sigma_data: float):
    B, S, d = f.shape
    return edm_loss_partials(f, z, y, sigma, sigma_data).sum() / (B * S * d)
