"""Run storage (port of ``pyabc_tpu/storage``: the sqlite History, the
JSON side-channel logs and the pyABC ORM-schema export).  The export CLI
(:mod:`.export`, which needs ``click``) is not imported here."""

from .bytes_storage import from_bytes, to_bytes
from .history import PRE_TIME, History, create_sqlite_db_id
from .json import load_dict_from_json, save_dict_to_json
from .reference_export import from_reference_db, to_reference_db

__all__ = ["History", "PRE_TIME", "create_sqlite_db_id",
           "save_dict_to_json", "load_dict_from_json", "to_bytes",
           "from_bytes", "to_reference_db", "from_reference_db"]
