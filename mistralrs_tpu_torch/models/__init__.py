"""Model configuration, parameters and the decoder."""
