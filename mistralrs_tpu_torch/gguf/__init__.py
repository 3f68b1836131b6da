"""GGUF files: a numpy/mmap reader (reader.py) and a writer (writer.py).

Counterpart of mistralrs_tpu/gguf/. The GGUF tokenizer and chat-template
conversion (mistralrs_tpu/gguf/tokenizer.py) are not ported yet.
"""
