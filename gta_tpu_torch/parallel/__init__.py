"""Parallel training for the port over torch.distributed: the (data, seq,
model) mesh (`dist.py`), head-sharded tensor parallel (`tp.py`), the
view-sharded GTA ring (`ring.py`) and ZeRO-1 (`zero.py`)."""
