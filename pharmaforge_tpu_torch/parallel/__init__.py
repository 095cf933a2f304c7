"""Data parallelism over `torch.distributed` (port of
`pharmaforge_tpu/parallel`)."""
