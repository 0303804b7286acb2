"""Runnable examples of the port: ``python -m mimamo_tpu_torch.examples.demo``
and ``python -m mimamo_tpu_torch.examples.serve_client``."""
