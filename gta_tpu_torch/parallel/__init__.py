"""Parallel training for the port: data parallel over torch.distributed
(`dist.py`)."""
