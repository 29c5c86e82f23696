"""Examples of the port, run as modules: ``python -m accelerate_tpu_torch.examples.<name>``."""
