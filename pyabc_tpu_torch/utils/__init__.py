"""Shared utilities (port of ``pyabc_tpu/utils``): the progress bar and
the deprecated alias of the transfer ledger."""
