"""Multi-process rendering and training over torch.distributed (counterpart
of ibgs_tpu/parallel/): one process per rank, meshes of named dims."""
