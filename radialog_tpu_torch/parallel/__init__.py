"""Multi-rank execution over torch.distributed: tensor-parallel serving, and
data- and tensor-parallel training (partition specs, autograd-aware
collectives, the multi-process dry runs)."""
