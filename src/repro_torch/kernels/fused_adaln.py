"""Fused AdaLN kernels (port of ``repro.kernels.fused_adaln``): so far the
forward gated residual, out = res + branch * (1 + gate), with a per-example
(B, d) gate broadcast over the sequence (CUDA source
``csrc/gate_residual.cu``). ``gate_residual`` launches the Hopper kernel on
CUDA tensors and runs ``gate_residual_ref`` on CPU tensors. The backward
kernel, ``fused_ln_modulate`` and ``fused_euler`` are not ported yet.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = {}


def gate_residual_ref(res, branch, gate):
    """Plain version: fp32 math, output in ``res``'s dtype."""
    return (res.float() + branch.float() * (1.0 + gate.float()[:, None, :])
            ).to(res.dtype)


def _kernel():
    if "fn" not in _FN:
        fn = _build.load("gate_residual").rt_gate_residual
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, LL, I, I, LL, I, I, P]
        fn.restype = I
        _FN["fn"] = fn
    return _FN["fn"]


def gate_residual(res, branch, gate):
    """res/branch: (B, S, d) fp32 or bf16, one dtype; gate: (B, d) fp32 or
    bf16 with unit stride along d (a column slice of the AdaLN head's output
    is fine). Returns (B, S, d) in res's dtype."""
    if res.device.type == "cpu":
        return gate_residual_ref(res, branch, gate)
    if res.device.type != "cuda" or branch.device != res.device \
            or gate.device != res.device:
        raise ValueError("gate_residual: res, branch and gate must share one "
                         "CUDA device")
    if res.dtype not in _DTYPES or branch.dtype != res.dtype \
            or gate.dtype not in _DTYPES:
        raise TypeError(f"gate_residual: res/branch must share fp32 or bf16 "
                        f"and gate be fp32 or bf16, got {res.dtype}, "
                        f"{branch.dtype}, {gate.dtype}")
    if res.ndim != 3 or branch.shape != res.shape:
        raise ValueError(f"gate_residual: res and branch must be (B, S, d) "
                         f"alike, got {tuple(res.shape)} and "
                         f"{tuple(branch.shape)}")
    B, S, d = res.shape
    if gate.ndim != 2 or tuple(gate.shape) != (B, d) or gate.stride(1) != 1:
        raise ValueError(f"gate_residual: gate must be (B, d) = {(B, d)} with "
                         f"unit stride along d, got {tuple(gate.shape)}")
    if d % 4:
        raise NotImplementedError("gate_residual: d must be a multiple of 4")
    if not (res.is_contiguous() and branch.is_contiguous()):
        raise ValueError("gate_residual: res and branch must be contiguous")
    if res.data_ptr() % 16 or branch.data_ptr() % 16:
        raise ValueError("gate_residual: res and branch must be 16-byte "
                         "aligned")
    out = torch.empty_like(res)
    with torch.cuda.device(res.device):
        rc = _kernel()(res.data_ptr(), branch.data_ptr(), gate.data_ptr(),
                       out.data_ptr(), B * S, S, d, gate.stride(0),
                       _DTYPES[res.dtype], _DTYPES[gate.dtype],
                       torch.cuda.current_stream(res.device).cuda_stream)
    _build.check(rc, "gate_residual")
    gate_residual.launches += 1
    return out


gate_residual.launches = 0
