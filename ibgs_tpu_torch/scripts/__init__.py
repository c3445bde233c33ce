"""The port's drivers: production training runs, the bench-bundle writer,
the snapshot replay, geometry evaluation and the COLMAP JSON converter
(counterparts of the JAX package's `scripts/`)."""
