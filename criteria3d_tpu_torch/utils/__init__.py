"""Host-side helpers: statistics, logging, telemetry and debug dumps."""
