"""Hand-written Hopper kernels and their plain PyTorch versions.

One module per TPU kernel module (``flash_decode``, ``flash_prefill``,
``fused_adaln``, ``flash_attention``, ``edm_loss``; ``ops`` routes the
model's calls onto them). Each wrapper launches its CUDA kernel on CUDA
tensors and runs its plain version on CPU tensors; it counts its launches in
``<wrapper>.launches``. Importing builds and loads nothing: a kernel is
compiled by ``_build`` at its first launch (or ahead with ``_build.build()``).
"""
from repro_torch.kernels import edm_loss as _edm
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import flash_prefill as _fp
from repro_torch.kernels import fused_adaln as _ad

WRAPPERS = {"flash_decode": _fd.flash_decode,
            "flash_prefill": _fp.flash_prefill,
            "gate_residual": _ad.gate_residual_fwd,
            "gate_residual_bwd": _ad.gate_residual_bwd,
            "ln_modulate_fwd": _ad.ln_modulate_fwd,
            "ln_modulate_bwd": _ad.ln_modulate_bwd,
            "euler_fwd": _ad.euler_fwd,
            "euler_bwd": _ad.euler_bwd,
            "edm_loss_fwd": _edm.edm_loss_fwd,
            "edm_loss_bwd": _edm.edm_loss_bwd,
            "flash_attention_fwd": _fa.flash_attention_fwd,
            "flash_attention_bwd_dq": _fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": _fa.flash_attention_bwd_dkv}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
