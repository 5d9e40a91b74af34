"""File formats: GGUF and WAV (NumPy only)."""
