"""Data parallelism over ranks (torch.distributed), the port's counterpart of
chap_tpu/parallel/."""
