"""Offline tools of the port (the reference's scripts/ that it ports)."""
