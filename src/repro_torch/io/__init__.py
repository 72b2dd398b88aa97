"""Ingestion/serialization boundary (port of ``repro/io``): AIGER files ->
AIGs."""
from repro_torch.io.aiger import (  # noqa: F401
    AigerError,
    AigerParseError,
    dump,
    dumps,
    load,
    loads,
    peek_name,
    source_bytes,
    structural_hash,
)
