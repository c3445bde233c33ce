"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch path (projection, binning, the per-tile-position blend and its
VJP, the warp and occlusion test, the epilogue, the fusion net, the IBGS
objective, per-group Adam and the served view's sequence), float32, with
every autograd Function routed to its plain version.  It imports nothing
of `ibgs_tpu_torch`, `ibgs_tpu`, `jax`, `jaxlib` or `flax`, and later
changes of the port do not reach it.  `precision.lowered` turns it into
the control."""
