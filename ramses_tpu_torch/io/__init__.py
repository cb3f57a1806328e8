"""Snapshot I/O: the reference's on-disk ``output_NNNNN/`` layout."""
