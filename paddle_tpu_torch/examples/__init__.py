"""Runnable twins of the repository's examples
(``python -m paddle_tpu_torch.examples.<name>``)."""
