"""The text pipeline the engine drives."""
