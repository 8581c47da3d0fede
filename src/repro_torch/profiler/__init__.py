"""Requirements from models: dry-run records become per-level memory
requirements (``traffic``)."""
