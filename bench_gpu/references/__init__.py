"""Plain references, one per kind of configuration."""
