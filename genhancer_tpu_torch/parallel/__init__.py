"""Data parallelism and ZeRO-1 over ``torch.distributed`` (``parallel.mesh``)."""
