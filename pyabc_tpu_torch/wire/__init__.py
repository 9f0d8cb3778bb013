"""The device-to-host wire (port of ``pyabc_tpu/wire``).

- :mod:`.transfer` — the ledger of wire bytes and seconds
  (``compute_s``, ``d2h_s``, ``overlap_s``, ...) and egress attribution;
- :mod:`.streaming` — :class:`StreamingIngest`, the bounded-depth
  background engine that overlaps a generation's fetch with the next
  generation's device work;
- :mod:`.ingest` — the wire decode and population assembly every ingest
  site shares, and :class:`~.ingest.GenStream`;
- :mod:`.store` — :class:`~.store.DeviceRunStore`, the device-resident
  ring of generations behind the lazy History.
"""

from . import transfer  # noqa: F401
from .streaming import IngestTicket, StreamingIngest, WireError  # noqa: F401
