"""Host runtime: the emission layer."""
