"""Multi-rank serving: tensor parallelism over torch.distributed."""
