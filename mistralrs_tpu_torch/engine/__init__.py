"""Serving runtime: engine, scheduler, sequences, sampling, page allocator.

Counterpart of mistralrs_tpu/engine/ (near-verbatim copies; see engine.py
for what is not ported yet).
"""
