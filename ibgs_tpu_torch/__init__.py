"""PyTorch / CUDA port of ibgs_tpu for NVIDIA Hopper (H100).

Module names mirror `ibgs_tpu` so each counterpart is easy to find.  The
port imports `torch` only: no JAX, no Flax and nothing of `ibgs_tpu`.
Public functions keep the JAX package's layouts (images `(H, W, C)`,
median buffers `(H, W, B)`), and every entry point takes a `device`
argument that defaults to `"cuda"`.

It covers the serving path (`eval.render_driver.EvalRenderer.render_one`:
depth re-render of the source views, the IBGS geometry render with the
image-based warp, the colour-fusion net) and the training step
(`train.trainer.make_train_step`: the full IBGS objective, backward through
the hand-written VJPs, per-group Adam, densification statistics).  The
blend forward and backward run through hand-written CUDA kernels
(`ops/csrc/blend_fwd.cu`, `ops/csrc/blend_bwd.cu`) on CUDA tensors, and
through their plain PyTorch versions on CPU tensors.
"""
