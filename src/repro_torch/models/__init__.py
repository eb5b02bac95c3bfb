from repro_torch.models.build import (
    Bundle,
    build_bundle,
    build_lm_bundle,
    build_tcn_bundle,
)
from repro_torch.models.config import ArchConfig

__all__ = ["ArchConfig", "Bundle", "build_bundle", "build_lm_bundle",
           "build_tcn_bundle"]
