"""Operator tools of the port (``python -m pyabc_tpu_torch.tools.<name>``):
the closed-loop load generator (:mod:`.loadgen`)."""
