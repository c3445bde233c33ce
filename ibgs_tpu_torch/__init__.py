"""PyTorch / CUDA port of ibgs_tpu for NVIDIA Hopper (H100).

Module names mirror `ibgs_tpu` so each counterpart is easy to find.  The
port imports `torch` only: no JAX, no Flax and nothing of `ibgs_tpu`.
Public functions keep the JAX package's layouts (images `(H, W, C)`,
median buffers `(H, W, B)`), and every entry point takes a `device`
argument that defaults to `"cuda"`.

It covers the serving path (`eval.render_driver.EvalRenderer.render_one`:
depth re-render of the source views, the IBGS geometry render with the
image-based warp, the colour-fusion net), the training step
(`train.trainer.make_train_step`: the full IBGS objective, backward through
the hand-written VJPs, per-group Adam, densification statistics) and the
training driver (`train.loop.train`, `python -m ibgs_tpu_torch.train`: a
scene from its seed cloud through KNN initialisation, the step schedule,
densify / prune, opacity reset, evaluation, snapshots and checkpoints,
the live viewer), the data layer (`data/`) and the evaluation of a
trained model (`python -m ibgs_tpu_torch.render` / `.metrics`: PNG
splits, FPS, memory, the TSDF mesh, PSNR / SSIM / LPIPS; `eval/video`).  The blend forward and backward run
through hand-written CUDA kernels
(`ops/csrc/blend_fwd.cu`, `ops/csrc/blend_bwd.cu`) on CUDA tensors, and
through their plain PyTorch versions on CPU tensors.
"""
