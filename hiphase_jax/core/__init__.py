from hiphase_jax.core.variants import (
    AlleleType,
    Variant,
    VariantError,
    VariantType,
    Zygosity,
)
from hiphase_jax.core.read_segments import ReadSegment, collapse_read_segments
from hiphase_jax.core.reference_genome import ReferenceGenome

__all__ = [
    "AlleleType",
    "Variant",
    "VariantError",
    "VariantType",
    "Zygosity",
    "ReadSegment",
    "collapse_read_segments",
    "ReferenceGenome",
]
