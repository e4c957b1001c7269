"""Model families (so far the dense decoder)."""
from repro_torch.models.model_api import build_model  # noqa: F401
