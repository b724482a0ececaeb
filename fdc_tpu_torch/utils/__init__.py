"""Host-side utilities: events, file sinks, logging."""
