"""Data parallelism over ``torch.distributed``: one process per device."""
