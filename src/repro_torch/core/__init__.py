"""Hardware registry, timing harness, benchmark registry, tile model."""
