"""Runnable examples of the port (`python -m mobocmf_tpu_torch.examples.<name>`)."""
