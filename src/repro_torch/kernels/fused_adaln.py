"""Fused AdaLN kernels (port of ``repro.kernels.fused_adaln``): the gated
residual, the non-parametric LayerNorm + AdaLN modulation and the fused EDM
Euler step, each with a hand-written backward.

  gate_residual: out = res + branch * (1 + gate)     (csrc/gate_residual.cu)
  ln_modulate:   out = LN(x) * (1 + scale) + shift   (csrc/ln_modulate.cu)
  euler:         z' = a z + b F                      (csrc/euler.cu)

gate/scale/shift are per-example (B, d) vectors broadcast over the sequence;
they may be column slices of the AdaLN head's (B, 6d) output (unit stride
along d, any row stride), which the kernels read in place.

The Euler step folds the denoiser combine D = c_skip z + c_out F and the
step z' = r z + (1 - r) D (r = σ_to/σ) into one pass with per-example fp32
coefficients a = r + (1 - r) c_skip, b = (1 - r) c_out (``euler_coeffs``);
at σ_to = 0 it returns D. z and F may be strided (unit stride along d).

Six wrappers, one per kernel, each counting its launches in ``.launches``:
``gate_residual_fwd``, ``gate_residual_bwd``, ``ln_modulate_fwd``,
``ln_modulate_bwd``, ``euler_fwd`` and ``euler_bwd``. On CUDA tensors they
launch the kernel or raise; on CPU tensors they run the plain versions
(``*_ref``). ``gate_residual``, ``ln_modulate`` and ``fused_euler`` tie each
pair together in a ``torch.autograd.Function`` whose backward calls the
backward wrapper, never autograd through the forward. The AdaLN backward
kernels write the (B, d) gradients themselves, summing their tiles' column
sums in a fixed order (JAX sums its kernels' (B, n_tiles, d) partials
outside them); they take an fp32 scratch sized by the kernel's own plan and
a zeroed ticket array kept per (device, stream), which each launch leaves
zero again.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LN_EPS = 1e-6
_FN = {}
_PLANS = {}           # AdaLN backward launch plans, by shape and device
_TICKETS = {}         # zeroed ticket arrays, by (device, stream)


# ---------------------------------------------------------------------------
# Plain versions (the JAX kernels' formulas, fp32 math)
# ---------------------------------------------------------------------------

def gate_residual_ref(res, branch, gate):
    """res + branch * (1 + gate), fp32 math, output in ``res``'s dtype."""
    return (res.float() + branch.float() * (1.0 + gate.float()[:, None, :])
            ).to(res.dtype)


def gate_residual_bwd_ref(branch, gate, g):
    """(d_branch, d_gate) of ``_gate_res_bwd_kernel``: d_branch =
    g * (1 + gate) in branch's dtype, d_gate = sum over rows of g * branch
    in gate's dtype (d_res is g itself)."""
    gf = g.float()
    d_branch = (gf * (1.0 + gate.float()[:, None, :])).to(branch.dtype)
    d_gate = (gf * branch.float()).sum(1).to(gate.dtype)
    return d_branch, d_gate


def _ln_stats(xf, eps):
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    return mean, torch.rsqrt(var + eps)


def ln_modulate_ref(x, scale, shift, eps: float = LN_EPS):
    """LN(x) * (1 + scale) + shift with ``_ln_mod_kernel``'s two-pass
    statistics, fp32 math, output in x's dtype."""
    xf = x.float()
    mean, rstd = _ln_stats(xf, eps)
    y = (xf - mean) * rstd
    y = y * (1.0 + scale.float()[:, None, :]) + shift.float()[:, None, :]
    return y.to(x.dtype)


def ln_modulate_bwd_ref(x, scale, g, eps: float = LN_EPS):
    """(dx, d_scale, d_shift) of ``_ln_mod_bwd_kernel``:
    dx = rstd * (dy - mean(dy) - xhat * mean(dy * xhat)), dy = g (1 + scale);
    d_scale = sum over rows of g * xhat, d_shift = sum over rows of g
    (both in scale's dtype)."""
    xf, gf = x.float(), g.float()
    mean, rstd = _ln_stats(xf, eps)
    xhat = (xf - mean) * rstd
    dy = gf * (1.0 + scale.float()[:, None, :])
    dx = rstd * (dy - dy.mean(-1, keepdim=True)
                 - xhat * (dy * xhat).mean(-1, keepdim=True))
    return (dx.to(x.dtype), (gf * xhat).sum(1).to(scale.dtype),
            gf.sum(1).to(scale.dtype))


def euler_coeffs(sigma, sigma_to, sigma_data: float):
    """(a, b), each (B,) fp32, of ``_euler_coeffs``: a = r + (1 - r) c_skip,
    b = (1 - r) c_out with r = σ_to/σ; sigma and sigma_to are (B,)."""
    sf = sigma.float().reshape(-1)
    s2 = sf ** 2
    d2 = sigma_data ** 2
    c_skip = d2 / (s2 + d2)
    c_out = sf * sigma_data * torch.rsqrt(s2 + d2)
    r = sigma_to.float().reshape(-1) / sf
    return r + (1 - r) * c_skip, (1 - r) * c_out


def euler_ref(z, f, a, b):
    """a z + b F with ``ref.euler_reference``'s formula: fp32 math, a and b
    (B,) broadcast over (S, d), output in z's dtype."""
    a3, b3 = a.float()[:, None, None], b.float()[:, None, None]
    return (a3 * z.float() + b3 * f.float()).to(z.dtype)


def euler_bwd_ref(g, a, b):
    """(dz, dF) = (a g, b g) of ``_euler_bwd_kernel``, in g's dtype."""
    gf = g.float()
    return ((a.float()[:, None, None] * gf).to(g.dtype),
            (b.float()[:, None, None] * gf).to(g.dtype))


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _kernel(lib: str, sym: str, argtypes):
    if sym not in _FN:
        fn = getattr(_build.load(lib), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FN[sym] = fn
    return _FN[sym]


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


def _check_rows(name, rows, vecs):
    """Raise on what the row-wise kernels do not take: ``rows`` (B, S, d)
    streams of one fp32/bf16 dtype, contiguous, 16-byte aligned, d a
    multiple of 4; ``vecs`` (B, d) fp32/bf16 with unit stride along d.
    Returns (B, S, d)."""
    x = rows[0]
    if any(t.device.type != "cuda" or t.device != x.device
           for t in rows + vecs):
        raise ValueError(f"{name}: every tensor must lie on one CUDA device")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in rows) \
            or any(t.dtype not in _DTYPES for t in vecs) \
            or any(t.dtype != vecs[0].dtype for t in vecs):
        raise TypeError(f"{name}: the (B, S, d) streams must share fp32 or "
                        f"bf16 and the (B, d) vectors be fp32 or bf16, got "
                        f"{[t.dtype for t in rows + vecs]}")
    if x.ndim != 3 or any(t.shape != x.shape for t in rows):
        raise ValueError(f"{name}: the streams must be (B, S, d) alike, got "
                         f"{[tuple(t.shape) for t in rows]}")
    B, S, d = x.shape
    if any(t.ndim != 2 or tuple(t.shape) != (B, d) or t.stride(1) != 1
           for t in vecs):
        raise ValueError(f"{name}: the per-example vectors must be (B, d) = "
                         f"{(B, d)} with unit stride along d, got "
                         f"{[tuple(t.shape) for t in vecs]}")
    if d % 4:
        raise NotImplementedError(f"{name}: d must be a multiple of 4")
    if S == 0 or B == 0:
        raise ValueError(f"{name}: empty batch or sequence")
    if not all(t.is_contiguous() for t in rows):
        raise ValueError(f"{name}: the (B, S, d) streams must be contiguous")
    if any(t.data_ptr() % 16 for t in rows):
        raise ValueError(f"{name}: the (B, S, d) streams must be 16-byte "
                         "aligned")
    return B, S, d


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def gate_residual_fwd(res, branch, gate):
    """res/branch: (B, S, d) fp32 or bf16, one dtype; gate: (B, d) fp32 or
    bf16 with unit stride along d. Returns (B, S, d) in res's dtype."""
    if res.device.type == "cpu":
        return gate_residual_ref(res, branch, gate)
    B, S, d = _check_rows("gate_residual", (res, branch), (gate,))
    out = torch.empty_like(res)
    fn = _kernel("gate_residual", "rt_gate_residual",
                 [_P, _P, _P, _P, _LL, _I, _I, _LL, _I, _I, _P])
    with torch.cuda.device(res.device):
        rc = fn(res.data_ptr(), branch.data_ptr(), gate.data_ptr(),
                out.data_ptr(), B * S, S, d, gate.stride(0),
                _DTYPES[res.dtype], _DTYPES[gate.dtype], _stream(res))
    _build.check(rc, "gate_residual")
    gate_residual_fwd.launches += 1
    return out


PLAN_FIELDS = ("scratch", "tickets", "cx", "ry", "tile_rows", "n_tiles",
               "cl")


def launch_plan(name, B, S, d, x_dtype, vec_dtype, device):
    """The launch plan of the row-wise AdaLN kernel ``name``
    (``"ln_modulate_fwd"``, ``"ln_modulate_bwd"`` or
    ``"gate_residual_bwd"``) for these shapes and dtypes on the CUDA
    ``device``, as the kernel's plan function reports it (``PLAN_FIELDS``):
    the fp32 scratch and tickets a launch takes (none for the forward),
    blocks of (cx, ry) threads, tiles of tile_rows rows, n_tiles of them an
    example in clusters of cl."""
    key = (name, B, S, d, x_dtype, vec_dtype, device.index)
    if key not in _PLANS:
        out = (ctypes.c_longlong * len(PLAN_FIELDS))()
        fn = _kernel(name.rsplit("_", 1)[0], f"rt_{name}_plan",
                     [_I, _I, _I, _I, _I, _P])
        with torch.cuda.device(device):
            rc = fn(B, S, d, _DTYPES[x_dtype], _DTYPES[vec_dtype], out)
        _build.check(rc, f"{name} plan")
        _PLANS[key] = dict(zip(PLAN_FIELDS, out))
    return _PLANS[key]


def _workspace(name, x, vec):
    """(fp32 scratch, tickets) for one launch of the AdaLN backward
    ``name`` on the (B, S, d) stream x and the (B, d) vector vec. The
    tickets are zero between launches; launches on one stream share them,
    so they run one after another."""
    B, S, d = x.shape
    plan = launch_plan(name, B, S, d, x.dtype, vec.dtype, x.device)
    scratch = torch.empty(plan["scratch"], dtype=torch.float32,
                          device=x.device)
    key = (x.device.index, _stream(x))
    tickets = _TICKETS.get(key)
    if tickets is None or tickets.numel() < plan["tickets"]:
        tickets = _TICKETS[key] = torch.zeros(max(plan["tickets"], 1024),
                                              dtype=torch.int32,
                                              device=x.device)
    return scratch, tickets


def gate_residual_bwd(branch, gate, g):
    """(d_branch like branch, d_gate like gate) from the cotangent g of the
    output (branch's dtype)."""
    if branch.device.type == "cpu":
        return gate_residual_bwd_ref(branch, gate, g)
    B, S, d = _check_rows("gate_residual_bwd", (branch, g), (gate,))
    scratch, tickets = _workspace("gate_residual_bwd", branch, gate)
    d_branch = torch.empty_like(branch)
    d_gate = torch.empty((B, d), dtype=gate.dtype, device=branch.device)
    fn = _kernel("gate_residual", "rt_gate_residual_bwd",
                 [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _LL, _I, _I, _P])
    with torch.cuda.device(branch.device):
        rc = fn(branch.data_ptr(), gate.data_ptr(), g.data_ptr(),
                d_branch.data_ptr(), d_gate.data_ptr(), scratch.data_ptr(),
                tickets.data_ptr(), B, S, d, gate.stride(0),
                _DTYPES[branch.dtype], _DTYPES[gate.dtype], _stream(branch))
    _build.check(rc, "gate_residual_bwd")
    gate_residual_bwd.launches += 1
    return d_branch, d_gate


def ln_modulate_fwd(x, scale, shift, eps: float = LN_EPS):
    """x: (B, S, d) fp32 or bf16; scale/shift: (B, d) of one dtype, fp32 or
    bf16, unit stride along d. Returns (B, S, d) in x's dtype."""
    if x.device.type == "cpu":
        return ln_modulate_ref(x, scale, shift, eps)
    B, S, d = _check_rows("ln_modulate", (x,), (scale, shift))
    out = torch.empty_like(x)
    fn = _kernel("ln_modulate", "rt_ln_modulate_fwd",
                 [_P, _P, _P, _P, _I, _I, _I, _LL, _LL, _F, _I, _I, _P])
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                out.data_ptr(), B, S, d, scale.stride(0), shift.stride(0),
                eps, _DTYPES[x.dtype], _DTYPES[scale.dtype], _stream(x))
    _build.check(rc, "ln_modulate")
    ln_modulate_fwd.launches += 1
    return out


def ln_modulate_bwd(x, scale, g, eps: float = LN_EPS):
    """(dx like x, d_scale, d_shift in scale's dtype) from the cotangent g
    of the output (x's dtype)."""
    if x.device.type == "cpu":
        return ln_modulate_bwd_ref(x, scale, g, eps)
    B, S, d = _check_rows("ln_modulate_bwd", (x, g), (scale,))
    scratch, tickets = _workspace("ln_modulate_bwd", x, scale)
    dx = torch.empty_like(x)
    sums = torch.empty((2, B, d), dtype=scale.dtype, device=x.device)
    fn = _kernel("ln_modulate", "rt_ln_modulate_bwd",
                 [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _LL, _F, _I, _I,
                  _P])
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(),
                sums.data_ptr(), scratch.data_ptr(), tickets.data_ptr(), B,
                S, d, scale.stride(0), eps, _DTYPES[x.dtype],
                _DTYPES[scale.dtype], _stream(x))
    _build.check(rc, "ln_modulate_bwd")
    ln_modulate_bwd.launches += 1
    return dx, sums[0], sums[1]


def _check_euler(name, streams, coeffs):
    """Raise on what the Euler kernels do not take: (B, S, d) fp32/bf16
    streams (z and F both fp32, both bf16, or fp32 z and bf16 F) with unit
    stride along d (any row strides), contiguous fp32 (B,) coefficients,
    all on one CUDA device. Returns (B, S, d) and whether every row start
    is 4-element aligned (the 4-wide path)."""
    x = streams[0]
    if any(t.device.type != "cuda" or t.device != x.device
           for t in streams + coeffs):
        raise ValueError(f"{name}: every tensor must lie on one CUDA device")
    if any(t.dtype not in _DTYPES for t in streams) \
            or any(t.dtype != torch.float32 for t in coeffs):
        raise TypeError(f"{name}: the (B, S, d) streams must be fp32 or bf16 "
                        f"and the coefficients fp32, got "
                        f"{[t.dtype for t in streams + coeffs]}")
    if streams[0].dtype == torch.bfloat16 \
            and any(t.dtype == torch.float32 for t in streams):
        raise TypeError(f"{name}: a bf16 z takes a bf16 F, got "
                        f"{[t.dtype for t in streams]}")
    if x.ndim != 3 or any(t.shape != x.shape for t in streams):
        raise ValueError(f"{name}: the streams must be (B, S, d) alike, got "
                         f"{[tuple(t.shape) for t in streams]}")
    B, S, d = x.shape
    if B == 0 or S == 0 or d == 0:
        raise ValueError(f"{name}: empty batch, sequence or width")
    if any(tuple(t.shape) != (B,) or not t.is_contiguous() for t in coeffs):
        raise ValueError(f"{name}: the coefficients must be contiguous (B,) "
                         f"= ({B},), got {[tuple(t.shape) for t in coeffs]}")
    if any(t.stride(2) != 1 for t in streams):
        raise ValueError(f"{name}: the streams need unit stride along d")
    vec = d % 4 == 0 and all(
        t.stride(0) % 4 == 0 and t.stride(1) % 4 == 0
        and t.data_ptr() % (4 * t.element_size()) == 0 for t in streams)
    return (B, S, d), vec


def euler_fwd(z, f, a, b):
    """z, F: (B, S, d) fp32 or bf16 (fp32 z may take a bf16 F; unit stride
    along d, any row strides); a, b: (B,) fp32. Returns a z + b F, contiguous, in
    z's dtype."""
    if z.device.type == "cpu":
        return euler_ref(z, f, a, b)
    (B, S, d), vec = _check_euler("euler", (z, f), (a, b))
    out = torch.empty((B, S, d), dtype=z.dtype, device=z.device)
    fn = _kernel("euler", "rt_euler_fwd",
                 [_P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _LL, _LL, _I, _I,
                  _I, _P])
    with torch.cuda.device(z.device):
        rc = fn(z.data_ptr(), f.data_ptr(), a.data_ptr(), b.data_ptr(),
                out.data_ptr(), B, S, d, z.stride(0), z.stride(1),
                f.stride(0), f.stride(1), _DTYPES[z.dtype], _DTYPES[f.dtype],
                int(vec), _stream(z))
    _build.check(rc, "euler")
    euler_fwd.launches += 1
    return out


def euler_bwd(g, a, b):
    """(dz, dF) = (a g, b g), contiguous, in g's dtype; g: (B, S, d) fp32 or
    bf16, contiguous; a, b: (B,) fp32."""
    if g.device.type == "cpu":
        return euler_bwd_ref(g, a, b)
    (B, S, d), vec = _check_euler("euler_bwd", (g,), (a, b))
    if not g.is_contiguous():
        raise ValueError("euler_bwd: g must be contiguous")
    dz, df = torch.empty_like(g), torch.empty_like(g)
    fn = _kernel("euler", "rt_euler_bwd",
                 [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P])
    with torch.cuda.device(g.device):
        rc = fn(g.data_ptr(), a.data_ptr(), b.data_ptr(), dz.data_ptr(),
                df.data_ptr(), B, S, d, _DTYPES[g.dtype], int(vec),
                _stream(g))
    _build.check(rc, "euler_bwd")
    euler_bwd.launches += 1
    return dz, df


for _w in (gate_residual_fwd, gate_residual_bwd, ln_modulate_fwd,
           ln_modulate_bwd, euler_fwd, euler_bwd):
    _w.launches = 0


# ---------------------------------------------------------------------------
# Differentiable entry points
# ---------------------------------------------------------------------------

class _GateResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, res, branch, gate):
        ctx.save_for_backward(branch, gate)     # as _gate_res_vjp_fwd
        return gate_residual_fwd(res, branch, gate)

    @staticmethod
    def backward(ctx, g):
        branch, gate = ctx.saved_tensors
        d_branch, d_gate = gate_residual_bwd(branch, gate, g.contiguous())
        return g, d_branch, d_gate              # d res: g itself, no copy


class _LnModulate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, shift, eps):
        ctx.save_for_backward(x, scale)         # as _ln_mod_vjp_fwd
        ctx.eps, ctx.shift_dtype = eps, shift.dtype
        return ln_modulate_fwd(x, scale, shift, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, d_scale, d_shift = ln_modulate_bwd(x, scale, g.contiguous(),
                                               ctx.eps)
        return dx, d_scale, d_shift.to(ctx.shift_dtype), None


class _Euler(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, f, sigma, sigma_to, sigma_data):
        a, b = euler_coeffs(sigma, sigma_to, sigma_data)
        ctx.save_for_backward(a, b)             # as _euler_vjp_fwd
        ctx.dtypes = (z.dtype, f.dtype)
        return euler_fwd(z, f, a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        dz, df = euler_bwd(g.contiguous(), a, b)
        # σ is sampled noise-schedule data, never a learnable input
        return dz.to(ctx.dtypes[0]), df.to(ctx.dtypes[1]), None, None, None


def gate_residual(res, branch, gate):
    """res/branch: (B, S, d); gate: (B, d). Differentiable through the
    backward kernel (its plain version on CPU tensors)."""
    return _GateResidual.apply(res, branch, gate)


def ln_modulate(x, scale, shift, eps: float = LN_EPS):
    """x: (B, S, d); scale/shift: (B, d). Non-parametric LN + AdaLN affine,
    differentiable through the backward kernel (its plain version on CPU
    tensors)."""
    return _LnModulate.apply(x, scale, shift, eps)


def fused_euler(z, f, sigma, sigma_to, sigma_data: float):
    """Fused denoise-combine + Euler step (paper Eq. 5 with the EDM
    parameterization): z' = (r + (1-r) c_skip) z + (1-r) c_out F. z/f:
    (B, S, d); sigma/sigma_to: (B,) per-example noise levels. Differentiable
    in z and F through the backward kernel (its plain version on CPU
    tensors); σ gets no gradient."""
    return _Euler.apply(z, f, sigma, sigma_to, sigma_data)
