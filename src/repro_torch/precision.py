"""Mixed-precision policy: the port of ``repro.precision``'s ``Policy``.

One frozen, hashable ``Policy`` names the dtype roles of the serving path:
``param_dtype`` (fp32 masters), ``compute_dtype`` (the streamed activations
and the weight copies the matmuls see: bf16 under ``bf16``) and ``kv_dtype``
(the paged KV pool; ``None`` follows the compute dtype, ``torch.int8``
stores quantized pages with per-page fp32 scales). Softmax and norm
statistics are fp32 under every policy. Recurrent families keep fp32
compute under ``bf16`` (``fp32_families``).

``cast_params_for_compute`` is the training cast: a differentiable copy of
every floating leaf in the compute dtype, so gradients flow back to the fp32
masters through the cast.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch.configs.base import HYBRID, SSM


@dataclasses.dataclass(frozen=True)
class Policy:
    name: str
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    fp32_families: Tuple[str, ...] = (SSM, HYBRID)
    kv_dtype: Optional[torch.dtype] = None

    def compute_for(self, family: Optional[str] = None) -> torch.dtype:
        """Effective compute dtype for an architecture family."""
        if family is not None and family in self.fp32_families:
            return torch.float32
        return self.compute_dtype

    @property
    def kv(self) -> torch.dtype:
        """KV-cache storage dtype (bf16 under the serving default)."""
        return self.compute_dtype if self.kv_dtype is None else self.kv_dtype

    @property
    def kv_quantized(self) -> bool:
        """True when the paged pool stores integer pages + per-page scales."""
        return not (self.kv.is_floating_point or self.kv.is_complex)


FP32 = Policy("fp32")
BF16 = Policy("bf16", compute_dtype=torch.bfloat16)
BF16_KVINT8 = Policy("bf16_kvint8", compute_dtype=torch.bfloat16,
                     kv_dtype=torch.int8)
FP32_KVINT8 = Policy("fp32_kvint8", kv_dtype=torch.int8)

_POLICIES = {"fp32": FP32, "float32": FP32, "bf16": BF16, "bfloat16": BF16,
             "mixed": BF16, None: FP32, "none": FP32,
             "bf16_kvint8": BF16_KVINT8, "fp32_kvint8": FP32_KVINT8,
             "int8": BF16_KVINT8, "kvint8": BF16_KVINT8}

PolicyLike = Union[None, str, Policy]


def get_policy(policy: PolicyLike) -> Policy:
    if isinstance(policy, Policy):
        return policy
    try:
        return _POLICIES[policy]
    except KeyError:
        raise ValueError(
            f"unknown precision policy {policy!r}; one of "
            f"{sorted(k for k in _POLICIES if isinstance(k, str))}") from None


def with_kv_dtype(policy: PolicyLike, kv_dtype) -> Policy:
    """Resolve a (precision, --kv-dtype) flag pair to a registered policy:
    ``with_kv_dtype('bf16', 'int8') -> BF16_KVINT8``. ``None``/``'auto'``
    keeps the base policy; unregistered combinations raise."""
    pol = get_policy(policy)
    if kv_dtype in (None, "", "auto"):
        return pol
    from repro_torch.nn.cache import resolve_kv_dtype
    want = resolve_kv_dtype(kv_dtype)
    if pol.kv == want:
        return pol
    for cand in _POLICIES.values():
        if (cand.compute_dtype == pol.compute_dtype
                and cand.param_dtype == pol.param_dtype
                and cand.kv == want):
            return cand
    raise ValueError(
        f"no registered precision policy stores {want} KV pages over "
        f"{pol.name!r} compute; known policies: "
        f"{sorted(k for k in _POLICIES if isinstance(k, str))}")


def cast_params_for_compute(policy: PolicyLike, params,
                            family: Optional[str] = None):
    """Compute-dtype weight copies for one loss evaluation: ``params``
    itself under fp32, else every floating leaf (norm gains and AdaLN heads
    included, as JAX casts them) through a differentiable ``.to``."""
    pol = get_policy(policy)
    cd = pol.compute_for(family)
    if cd == pol.param_dtype:
        return params
    from repro_torch.nn.init import tree_map
    return tree_map(lambda _, x: x.to(cd) if x.is_floating_point() else x,
                    params)
