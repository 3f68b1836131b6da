"""Device-memory helpers."""
