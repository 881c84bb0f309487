"""Host-side video decoding and preprocessing (copies of the JAX package's)."""
