from repro_torch.models.build import (
    Bundle,
    build_bundle,
    build_lm_bundle,
    build_tcn_bundle,
    input_specs,
    make_empty_cache,
)
from repro_torch.models.config import ArchConfig

__all__ = ["ArchConfig", "Bundle", "build_bundle", "build_lm_bundle",
           "build_tcn_bundle", "input_specs", "make_empty_cache"]
