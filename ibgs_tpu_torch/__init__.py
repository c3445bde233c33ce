"""PyTorch / CUDA port of ibgs_tpu for NVIDIA Hopper (H100).

Module names mirror `ibgs_tpu` so each counterpart is easy to find.  The
port imports `torch` only: no JAX, no Flax and nothing of `ibgs_tpu`.
Public functions keep the JAX package's layouts (images `(H, W, C)`,
median buffers `(H, W, B)`), and every entry point takes a `device`
argument that defaults to `"cuda"`.

This slice covers the serving path: depth re-render of the source views,
the IBGS geometry render with the image-based warp, and the colour-fusion
net (`eval.render_driver.EvalRenderer.render_one`).  The blend forward runs
through a hand-written CUDA kernel (`ops/csrc/blend_fwd.cu`) on CUDA
tensors, and through its plain PyTorch version on CPU tensors.
"""
