"""Quantized linear layers: the `Linear` record, GGUF device layouts, fusion."""
