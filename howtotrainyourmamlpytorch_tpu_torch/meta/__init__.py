"""Inner loop and meta-state."""
