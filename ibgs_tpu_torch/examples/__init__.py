"""Examples of the port's public API (counterparts of the JAX package's
`examples/`)."""
