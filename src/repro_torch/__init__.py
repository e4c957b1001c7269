"""DiffusionBlocks in PyTorch for NVIDIA Hopper (H100).

The second package of this repository, beside the JAX reference ``repro``.
It keeps ``repro``'s module layout and names so each part has an obvious
counterpart, and imports nothing of it: configs and partition helpers are
copied. Hand-written CUDA kernels for ``sm_90a`` live in
``repro_torch.kernels`` (sources under ``kernels/csrc``, built with ``nvcc``
at first use); on CPU tensors every kernel wrapper runs its plain PyTorch
version instead.

Ported so far, for dense decoders: the paged block-wise serving path
(``launch.serve`` → ``core.blocks`` → ``models`` → ``nn.cache`` and the
flash-decode, flash-prefill and gate-residual kernels), and DiffusionBlocks
training in concat mode with CE plus the end-to-end baseline
(``launch.train`` → ``core.training`` → ``core.blocks.block_loss`` →
``models`` → ``nn.attention`` and the flash-attention forward, dq and
dk/dv kernels).
"""
