from hiphase_jax.align.edit_distance import edit_distance

__all__ = ["edit_distance"]
